"""The forward blend's share of its roofline over the traced window's
frames, in %: each frame's bound (counts/bounds.py, on the reference's
counts for its camera) summed, over the device time of the forward blend
kernels (`fwd_kernel`, both tile sizes)."""
from bench_h100.counts.bounds import blend_fwd_bound_s
from bench_h100.harness import trace as T

KERNEL = r"(?<![A-Za-z0-9_])fwd_kernel\b"


def read(w):
    if w.kind != "render" or not w.counts or not w.units:
        return None
    ns, launches = T.kernel_ns(w, KERNEL)
    if not launches:
        return None
    cams = w.counts["per_camera"]
    need = sum(blend_fwd_bound_s(cams[v]) for views in w.unit_views
               for v in views)
    return 100.0 * need / (ns / 1e9)
