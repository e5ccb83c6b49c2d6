"""output_tok_per_s (tokens/s, host clock): tokens generated in the window
(each request's first, from its prefill, and its decode steps') over the
window's wall, prefills included."""


def read(run):
    return sum(b.requests * b.new_tokens for b in run.batches
               if b.ok) / run.window_s
