"""attn_roofline.decode (%, program span): the least time of the traced
decode steps' attention over the device time launched inside the
program's ``lm.attn.core`` spans nested in ``lm.decode_step`` spans
(``_decode_attention``; the cache write lies outside the span).  A step at
cache position p reads, a layer, the keys and values of positions 0..p
once (2 B (p + 1) n_kv D bf16 bytes over 3.35 TB/s) and does 4 B Hq D
(p + 1) flops (over 989 TFLOP/s); its least time is the larger."""

from bench import roofline, spans


def read(run):
    if run.trace is None:
        return None
    spent = spans.device_s(run.trace, ("lm.attn.core",),
                           within="lm.decode_step")
    done = [b for b in run.traced if b.ok and b.new_tokens]
    if not spent or not done:
        return None
    c = run.port
    least = 0.0
    for b in done:
        s = b.prompt_tokens // b.requests
        for j in range(b.new_tokens):
            keys = b.requests * (s + j + 1)
            least += roofline.least_time_s(
                4 * keys * c["n_q"] * c["d_head"],
                2 * keys * c["n_kv"] * c["d_head"] * roofline.BF16_BYTES)
    return roofline.share(c["n_layers"] * least, spent)
