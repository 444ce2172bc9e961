"""The model FLOPs of the clips that exist in the traced window's videos
(portbench/flops.py: every conv's forward, comb1 at each tap's
resolution), over the window's wall times the configuration's peak (fp32
67 TFLOP/s with TF32 off, bf16 989): the whole forward's share of the
card. Padding clips of a chunk do no model work. Moves frames_per_s."""


def read(ctx):
    if ctx["trace"] is None or not ctx["videos"]:
        return None
    clips = sum(v["valid_clips"] for v in ctx["videos"])
    return 100.0 * clips * ctx["clip_flops"] / (ctx["window_s"] * ctx["peak_flops"])
