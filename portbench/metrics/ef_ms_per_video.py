"""Host milliseconds a video of the EF layer (`infer/ef`: the area curve,
peaks, pairs and Simpson's pucks), timed by the benchmark around each call
on its EF worker, over the traced window's videos. Moves video_p95_ms."""


def read(ctx):
    ef = ctx.get("ef_s")
    return 1e3 * sum(ef) / len(ef) if ef else None
