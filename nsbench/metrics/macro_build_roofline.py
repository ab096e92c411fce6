"""macro_build_roofline (%): the macro path's block value build
(`ops/macroblock.py build_macro_values`, kernel B) as a share of its
roofline.  The benchmark wraps `build_macro_values` in a host span; the
device time is that of the kernels launched inside it.  Each call's least
time counts the element matrices F_e [E, nloc, nloc] and the block values
FtT [B, U, U] once, and the slot table [B, c_blk, nloc] at 4 bytes a
slot, against E nloc^2 additions (`nsbench/roofline.py`).  Moves
device_ms_per_step."""

from nsbench.roofline import share_percent

SPAN = ("navierstokes_project_nm4pde_tpu_torch.ops.macroblock", "build_macro_values")


def cost(args, kwargs):
    mp, F_e = args[:2]
    E, nloc = F_e.shape[0], F_e.shape[1]
    B, c_blk = mp.lidx.shape[0], mp.lidx.shape[1]
    U = mp.U
    s = F_e.element_size()
    return E * nloc * nloc * s + B * U * U * s + 4 * B * c_blk * nloc, E * nloc * nloc, s


def read(ctx):
    if ctx.trace is None:
        return None
    return share_percent(ctx.calls.get("macro_build_roofline", []), ctx.trace.span_device_s("macro_build_roofline"))
