"""decode_roofline (%, program span): the decode steps' least time by the
roofline (the larger of their flops over 989 TFLOP/s and the bytes each
needs, ``roofline.decode_step_bytes``, over 3.35 TB/s) over the decode
loops' own synchronised walls.  Every routed expert that gets a token is
read once; a random router gives each expert a token but with probability
about e^-6 at 64 tokens of top 6 of 64 (``roofline.experts_touched``)."""

from bench import roofline


def read(run):
    done = [b for b in run.batches if b.ok and b.new_tokens]
    least = 0.0
    for b in done:
        s = b.prompt_tokens // b.requests
        for j in range(b.new_tokens):
            least += roofline.least_time_s(
                roofline.decode_step_flops(run.port, b.requests, s + j),
                roofline.decode_step_bytes(run.port, b.requests, s + j))
    wall = sum(b.decode_s for b in done)
    return roofline.share(least, wall)
