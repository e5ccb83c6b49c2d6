"""prefill_tok_per_s (tokens/s, host clock): prompt tokens of the window's
served batches over the window's wall."""


def read(run):
    return sum(b.prompt_tokens for b in run.batches if b.ok) / run.window_s
