"""macro_apply_roofline (%): the macro path's F apply
(`ops/macroblock.py apply_macro`: slot gather, kernel A, node reduce) as a
share of its roofline.  The benchmark wraps `apply_macro` in a host span;
the device time is that of the kernels launched inside the span.  Each
call's least time counts the block values FtT [B, U, U] and the input and
output [n, C] once, and one 4-byte slot index a block slot, against
2 B U^2 C operations (`nsbench/roofline.py`).  Moves device_ms_per_step."""

from nsbench.roofline import share_percent

SPAN = ("navierstokes_project_nm4pde_tpu_torch.ops.macroblock", "apply_macro")


def cost(args, kwargs):
    mp, FtT, u = args[:3]
    B, U = FtT.shape[0], FtT.shape[1]
    n, C = u.shape[0], u.numel() // u.shape[0]
    s = FtT.element_size()
    return B * U * U * s + 2 * n * C * s + 4 * B * U, 2 * B * U * U * C, s


def read(ctx):
    if ctx.trace is None:
        return None
    return share_percent(ctx.calls.get("macro_apply_roofline", []), ctx.trace.span_device_s("macro_apply_roofline"))
