"""element_pass_roofline (%): the element pass of the velocity operator
(`ops/operators.py apply_F`: kernel D's gather, the folded element
product `element_apply`, kernel C's reduce), on a sweep's [n, 3, B]
member columns, as a share of its roofline.  The benchmark wraps
`apply_F` in a host span; the device time is that of the kernels launched
inside it.  Each call's least time counts the folded element matrices
F_e once, the input and output [n, 3, B] once and the cells' node table
[E, nloc] at 4 bytes a node, against 2 x 3 operations an element-matrix
entry (`nsbench/roofline.py`).  A call with no folded F_e (fold_elem off)
has no count, and the metric is then not read.  Moves steps_per_s."""

from nsbench.roofline import share_percent

SPAN = ("navierstokes_project_nm4pde_tpu_torch.ops.operators", "apply_F")


def cost(args, kwargs):
    conv = args[3] if len(args) > 3 else kwargs.get("conv")
    u = args[4] if len(args) > 4 else kwargs["u"]
    if conv is None or getattr(conv, "F_e", None) is None:
        return None
    F_e = conv.F_e
    # [nloc, E, nloc, B] for members, [E, nloc, nloc] for one run
    E, nloc = (F_e.shape[1], F_e.shape[0]) if F_e.dim() == 4 else (F_e.shape[0], F_e.shape[1])
    s = F_e.element_size()
    return F_e.numel() * s + 2 * u.numel() * s + 4 * E * nloc, 2 * 3 * F_e.numel(), s


def read(ctx):
    calls = ctx.calls.get("element_pass_roofline", [])
    if ctx.trace is None or any(c is None for c in calls):
        return None
    return share_percent(calls, ctx.trace.span_device_s("element_pass_roofline"))
