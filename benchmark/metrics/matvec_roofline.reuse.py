"""matvec_roofline.reuse: the 7-point product's (in the
preconditioner's dtype, float32 here) share of its
roofline, in %: the frozen bound (reference/roofline.py) over the
device time per call of the ``matvec32`` span (profiler).  Nothing on a
card the peaks table does not know."""


def read(t):
    tr = t.trace
    peaks = t.roofline.PEAKS.get(t.device_kind)
    calls = tr.range_calls.get("matvec32", 0) if tr else 0
    secs = tr.range_device_s.get("matvec32", 0.0) if tr else 0.0
    if peaks is None or not calls or secs <= 0:
        return None
    dtype = t.config["precision"]["pc_dtype"]
    isz = {"float32": 4, "float64": 8}[dtype]
    n_bytes, flops = t.roofline.stencil_model(t.n_dof, isz)
    bound, _ = t.roofline.bound_ms(n_bytes, flops, dtype, peaks)
    return 100.0 * bound / (1e3 * secs / calls)
