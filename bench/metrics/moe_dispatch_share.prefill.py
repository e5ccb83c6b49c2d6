"""moe_dispatch_share.prefill (%, program span): the device time launched
inside the program's ``lm.moe.route``, ``lm.moe.dispatch`` and
``lm.moe.combine`` spans of the traced prefills (the router's softmax and
top-k, the slot ranks, the buffer and its ``index_copy_``, the gather, the
weighting and the K adds) over the device time launched inside their
``lm.prefill`` spans: the MoE glue around the expert matmuls."""

from bench import roofline, spans

GLUE = ("lm.moe.route", "lm.moe.dispatch", "lm.moe.combine")


def read(run):
    if run.trace is None or not spans.intervals(run.trace, GLUE[0],
                                                within="lm.prefill"):
        return None
    glue = spans.device_s(run.trace, GLUE, within="lm.prefill")
    return roofline.share(glue, spans.device_s(run.trace, ("lm.prefill",)))
