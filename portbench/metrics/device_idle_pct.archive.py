"""The card's idle share in the traced archive window: 100 x (1 - the union
of its kernel, copy and memset intervals over the window), from
torch.profiler's device trace. Moves frames_per_s."""


def read(ctx):
    trace = ctx["trace"]
    return None if trace is None else trace.idle_pct()
