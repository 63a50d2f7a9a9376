"""The backward blend's share of its roofline over the traced window's
steps, in %: each view's bound (counts/bounds.py, on the reference's
counts for its camera at the window's starting state) summed over the
steps' views, over the device time of the backward blend kernels
(`bwd_kernel`, both tile sizes)."""
from bench_h100.counts.bounds import blend_bwd_bound_s
from bench_h100.harness import trace as T

KERNEL = r"(?<![A-Za-z0-9_])bwd_kernel\b"


def read(w):
    if w.kind != "train" or not w.counts or not w.units:
        return None
    ns, launches = T.kernel_ns(w, KERNEL)
    if not launches:
        return None
    cams = w.counts["per_camera"]
    need = sum(blend_bwd_bound_s(cams[v]) for views in w.unit_views
               for v in views)
    return 100.0 * need / (ns / 1e9)
