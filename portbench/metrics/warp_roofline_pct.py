"""K2-K4's share of their rooflines in the traced train window: the summed
least time of the warp launches over their summed device time. The
channels of each launch come from its kernel's template arguments
(`warp_forward_kernel<CA, CB>`, `warp_image_grad_kernel<C>` with its
count, place and fill passes, `warp_coord_grad_kernel<C>`); every launch
of the fused loss warps 2 x batch images of the clip's frame size (the
forward and backward chains of each sample). The least times are the
operands once at 3.35 TB/s, a frozen copy of chip_smoke's warp bytes
(portbench/peaks.py); K3's memset is not counted. Silent where a launch
has a channel count known only at run time. Moves train_step_ms."""

import re

from portbench.peaks import warp_bound_s

K2 = re.compile(r"warp_forward_kernel<(-?\d+),\s*(-?\d+)>")
K3 = re.compile(r"warp_image_grad_kernel<(-?\d+)>")
K3_PASS = re.compile(r"warp_image_grad_kernel_(count|place|fill)")
K4 = re.compile(r"warp_coord_grad_kernel<(-?\d+)>")


def read(ctx):
    trace, cfg, traffic = ctx["trace"], ctx["config"], ctx["traffic"]
    if trace is None:
        return None
    pixels = 2 * traffic["batch"] * cfg["height"] * cfg["width"]
    bound = time = 0.0
    for name, s, e in trace.kernels:
        for kind, rx in (("K2", K2), ("K3", K3), ("K4", K4)):
            m = rx.search(name)
            if m:
                channels = [int(c) for c in m.groups()]
                if channels[0] < 1 or min(channels) < 0:
                    return None
                bound += warp_bound_s(kind, pixels, *channels)
                time += (e - s) / 1e6
        if K3_PASS.search(name):
            time += (e - s) / 1e6
    return 100.0 * bound / time if time > 0 else None
