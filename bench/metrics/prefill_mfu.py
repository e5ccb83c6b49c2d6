"""prefill_mfu (%, program span): model flops of the window's prefills
(``roofline.prefill_flops``: 2 x active parameters a token x prompt tokens,
causal attention's 4 Hq D a visible pair, the head at the last position;
not the capacity padding) over the prefills' own synchronised walls
(``Generation.prefill_s``), over 989 TFLOP/s."""

from bench import roofline


def read(run):
    done = [b for b in run.batches if b.ok]
    flops = sum(roofline.prefill_flops(run.port, b.requests,
                                       b.prompt_tokens // b.requests)
                for b in done)
    wall = sum(b.prefill_s for b in done)
    return roofline.share(flops / roofline.BF16_FLOPS_PER_S, wall)
