"""moe_dropped_share.decode (%, program span): the share of the traced
decode steps' routed slots that found their expert full, 100 x (routed -
kept) / routed.  The kept slots are the program's counter of the decode
phase, which counts only while the profiler records, as the spans do;
the routed slots follow from the traced batches' shapes, top_k slots of
each request in each of the n_layers MoE layers of each decode step.
Read, as the other program spans are, from a traced run on the card (none
without its device operations).  A dropped slot leaves its token without
that expert's output."""

from bench import roofline, spans


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    kept = spans.kept_slots("decode")
    c = run.port
    routed = sum(c["n_layers"] * b.requests * c["top_k"] * b.new_tokens
                 for b in run.traced)
    if kept is None or not routed:
        return None
    return roofline.share(routed - kept, routed)
