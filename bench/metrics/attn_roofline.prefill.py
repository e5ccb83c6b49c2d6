"""attn_roofline.prefill (%, device trace): the least time of the traced
prefills' attention calls (``roofline.b3_bound`` of each layer's causal
GQA call at the batch's own prompt length, copied from ``chip_smoke.py``)
over the summed device time of the kernels that compute that attention,
found by name: B3's two entries (``tc_kernel`` bf16, ``f32_kernel``) and
PyTorch's SDPA kernels, so that the same work is read whichever
implements it."""

from bench import roofline

KERNELS = ("tc_kernel", "f32_kernel", "flash_fwd", "fmha", "efficient_attention",
           "pytorch_flash")


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_s(KERNELS)
    done = [b for b in run.traced if b.ok]
    if not spent or not done:
        return None
    c = run.port
    bound = sum(roofline.b3_bound(b.requests, c["n_q"], c["n_kv"],
                                  b.prompt_tokens // b.requests,
                                  c["d_head"])[0] for b in done)
    return roofline.share(c["n_layers"] * bound, spent)
