"""The card's idle share in the traced train window: 100 x (1 - the union
of its kernel, copy and memset intervals over the window), from
torch.profiler's device trace. Moves train_step_ms."""


def read(ctx):
    trace = ctx["trace"]
    return None if trace is None else trace.idle_pct()
