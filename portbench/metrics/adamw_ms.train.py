"""One ``optim.adamw_update`` with its gate scales
(``optim/sparse.gated_scale_tree``) on the cell's state, timed apart
after the window, with device synchronises around it, in ms."""


def read(ctx):
    if ctx.get("kind") != "train" or ctx.get("adamw_s") is None:
        return None
    return 1e3 * ctx["adamw_s"]
