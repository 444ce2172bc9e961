"""K1's share of its roofline in the traced archive window: the summed
least time of its launches over their summed device time (kernel
`decoder_heads_kernel`). Each launch is one forward chunk of the
window's videos, B clips x 32 frames, with the projections at the
backbone's distinct tap resolutions; its least time is a frozen copy of
`chip_smoke.k1_bound` (portbench/peaks.py: comb2 as 3xTF32 on the tensor
cores, the rest on the CUDA cores, the operands once). Silent where the
trace holds another number of launches than the videos' chunks. Moves
frames_per_s."""

import sys

from portbench.flops import conv_flops
from portbench.peaks import k1_bound_s


def read(ctx):
    trace, cfg = ctx["trace"], ctx["config"]
    if trace is None or not ctx["videos"]:
        return None
    launches = trace.launches(r"decoder_heads_kernel")
    chunks = [b for v in ctx["videos"] for b in v["chunks"]]
    if len(launches) != len(chunks):
        print(f"k1_roofline_pct: {len(launches)} K1 launches in the trace, "
              f"{len(chunks)} chunks in its videos", file=sys.stderr)
        return None
    _, taps = conv_flops(cfg)
    sources = list(dict.fromkeys((h, w) for _, h, w in dict.fromkeys(taps)))
    bound = sum(k1_bound_s(b, cfg["clip_length"], sources, cfg["decoder_width"],
                           (cfg["height"], cfg["width"])) for b in chunks)
    return 100.0 * bound / sum(t for _, t in launches)
