"""expert_roofline.prefill (%, program span): the least time of the
routed experts' useful work in the traced prefills over the device time
launched inside the program's ``lm.moe.experts`` spans nested in
``lm.prefill`` spans (the three expert ``bmm``s and the SwiGLU).  The work
is 2 x ``roofline.expert_weights`` flops a kept slot (the program's
counter of the slots kept in the prefill phase) over 989 TFLOP/s, against
every routed expert's bf16 weights read once a layer call over 3.35 TB/s;
the least time is the larger.  The buffer's padding rows (E C rows hold
fewer kept slots) count as time, not as work."""

from bench import roofline, spans


def read(run):
    if run.trace is None:
        return None
    kept = spans.kept_slots("prefill")
    calls = len(spans.intervals(run.trace, "lm.moe.experts",
                                within="lm.prefill"))
    if not kept or not calls:
        return None
    spent = spans.device_s(run.trace, ("lm.moe.experts",),
                           within="lm.prefill")
    c = run.port
    w = roofline.expert_weights(c)
    least = roofline.least_time_s(
        2 * w * kept,
        calls * c["n_experts"] * w * roofline.BF16_BYTES)
    return roofline.share(least, spent)
