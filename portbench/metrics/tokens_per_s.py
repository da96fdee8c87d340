"""tokens_per_s (tokens/s): tokens of every step completed in the window
(batch x sequence a step), over the window's seconds."""


def read(run):
    if run.window_s <= 0 or "tokens" not in run.units:
        return None
    return run.units["tokens"] / run.window_s
