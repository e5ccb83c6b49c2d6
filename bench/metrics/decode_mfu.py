"""decode_mfu (%, program span): model flops of the window's decode steps
(``roofline.decode_step_flops`` at each step's cache position) over the
decode loops' own synchronised walls (``Generation.decode_s``), over
989 TFLOP/s."""

from bench import roofline


def read(run):
    done = [b for b in run.batches if b.ok and b.new_tokens]
    flops = 0.0
    for b in done:
        s = b.prompt_tokens // b.requests
        flops += sum(roofline.decode_step_flops(run.port, b.requests, s + j)
                     for j in range(b.new_tokens))
    wall = sum(b.decode_s for b in done)
    return roofline.share(flops / roofline.BF16_FLOPS_PER_S, wall)
