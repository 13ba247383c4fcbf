"""What the CPU can reach of the fused AdamW's launch (``kernels/adamw``):
the table of leaves and chunks, the rows-of-runs description of a view
(ZeRO-1 blocks narrowed along any dim), the per-row description of a gate
scale, the 64-bit offsets, and the argument checks. An emulation of the
kernel's addressing reads and writes each element where the table says;
the plain update of the gathered elements, scattered back, must equal the
plain update of the views bit for bit. The kernels themselves run in
``tests/test_torch_cuda.py`` on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.adamw import kernel as K, ref
from repro_torch.optim.optimizer import AdamWConfig


def _offsets(row, ptr, rs, base):
    """The offsets, in elements from ``base``'s first, at which the kernel
    finds each element of a view of ``base``, by its formula: ``ptr`` and
    ``rs`` the table fields of the view's pointer and row stride."""
    n, run = int(row[K.F_N]), int(row[K.F_RUN])
    e = np.arange(n, dtype=np.int64)
    r, c = (np.zeros_like(e), e) if n == run else (e // run, e % run)
    start = (int(row[ptr]) - base.data_ptr()) // base.element_size()
    return start + r * int(row[rs]) + c


def _scale_offsets(row, base):
    e = np.arange(int(row[K.F_N]), dtype=np.int64)
    o = np.zeros_like(e)
    for k in range(int(row[K.F_NTERMS])):
        div, size, stride = row[K.F_TERMS + 3 * k:K.F_TERMS + 3 * k + 3]
        o += (e // div % size) * stride
    return (int(row[K.F_S]) - base.data_ptr()) // base.element_size() + o


def _true_offsets(view, base):
    """Where ``view``'s elements lie in contiguous ``base``, in order."""
    idx = torch.arange(base.numel())
    return torch.as_strided(idx, view.shape, view.stride(),
                            view.storage_offset()).flatten().numpy()


BASE = (4, 6, 16, 8)


@pytest.mark.parametrize("dim", [None, 0, 1, 2, 3])
@pytest.mark.parametrize("scale", [None, "scalar", "layer", "mask"])
def test_emulated_addressing_equals_the_plain_update_bitwise(dim, scale):
    """A leaf ``[L, E, K, O]`` whole or as a ZeRO-1 block (2 of 4 along
    ``dim`` of the parameter and gradient, the moments of the block's
    shape), with no scale, a 0-d one, a per-layer gate or a per-layer ×
    N:M mask ``[L, 1, K, 1]``: the table's offsets are the views' own, the
    scale's offsets the broadcast scale's, and updating the gathered
    elements then scattering them back gives the plain update's bits."""
    gen = torch.Generator().manual_seed(5)
    p0 = torch.randn(BASE, generator=gen).to(torch.bfloat16)
    g0 = torch.randn(BASE, generator=gen)
    s = {None: None, "scalar": torch.tensor(0.5),
         "layer": torch.tensor([1.0, 0.0, 1.0, 1.0]).reshape(4, 1, 1, 1),
         "mask": (torch.rand((4, 1, 16, 1), generator=gen) < 0.5).float()
         * torch.tensor([1.0, 0.0, 1.0, 1.0]).reshape(4, 1, 1, 1)}[scale]

    def views(p, g):
        if dim is None:
            return g, p, s
        w = BASE[dim] // 2
        sv = None if s is None \
            else torch.broadcast_to(s, BASE).narrow(dim, w, w)
        return g.narrow(dim, w, w), p.narrow(dim, w, w), sv
    g, p, sv = views(p0, g0)
    m = torch.rand(p.shape, generator=gen)
    v = torch.rand(p.shape, generator=gen)
    row, keep = K.update_entry(g, p, m, v, sv)
    assert keep[0] is g                  # no copy of a narrowed gradient
    fields = {"p": (K.F_P, K.F_RS_P, p, p0), "g": (K.F_G, K.F_RS_G, g, g0),
              "m": (K.F_M, K.F_RS_M, m, m), "v": (K.F_V, K.F_RS_V, v, v)}
    o = {}
    for name, (f, rs, t, base) in fields.items():
        o[name] = _offsets(row, f, rs, base)
        assert np.array_equal(o[name], _true_offsets(t, base)), name
    gs = None
    if s is not None:
        gs = s.flatten()[_scale_offsets(row, s)]
        assert torch.equal(gs, torch.broadcast_to(sv, p.shape).flatten())
    # the plain update of the views, and of the elements the kernel would
    # read, scattered back where it would write them
    cfg, clip = AdamWConfig(lr=1e-2), torch.tensor(0.75)
    hyper = (1e-2, 0.1, 0.05)            # lr, bc1, bc2
    want_p, want_m, want_v = p0.clone(), m.clone(), v.clone()
    wg, wp, ws = views(want_p, g0)
    ref.update(wg, wp, want_m, want_v, ws, clip, cfg, *hyper)
    flat = {name: f[3].view(-1) for name, f in fields.items()}
    gp, gm, gv = (flat[n][torch.from_numpy(o[n])] for n in "pmv")
    ref.update(flat["g"][torch.from_numpy(o["g"])], gp, gm, gv, gs, clip, cfg,
               *hyper)
    for n, x in zip("pmv", (gp, gm, gv)):
        flat[n][torch.from_numpy(o[n])] = x
    assert torch.equal(p0, want_p)
    assert torch.equal(m, want_m) and torch.equal(v, want_v)


def test_chunk_table_over_a_tree():
    """Rows of the non-empty leaves in order, each with its first chunk; a
    leaf of n elements takes ceil(n / CHUNK) chunks; the ticket ends the
    table at 0."""
    sizes = [0, 1, K.CHUNK, K.CHUNK + 1, 3 * K.CHUNK - 5, 7]
    leaves = [torch.zeros(n) for n in sizes]
    entries = [K.norm_entry(g, i % 2 == 1) for i, g in enumerate(leaves)]
    plan = K.table(entries)
    rows = plan.table[:-1].reshape(-1, K.FIELDS)
    assert plan.table[-1] == 0 and plan.leaves == len(rows) == 5
    assert list(rows[:, K.F_N]) == sizes[1:]
    assert list(rows[:, K.F_FIRST]) == [0, 1, 2, 4, 7]
    assert plan.chunks == 8 and plan.elems == sum(sizes)
    assert list(rows[:, K.F_FLAGS] & K.SPLIT != 0) == [True, False, True,
                                                       False, True]
    assert len(plan.keep) == 5


@pytest.mark.parametrize("shape,dim,want", [
    ((4, 6, 16, 8), None, (1, 3072, 3072)),
    ((4, 6, 16, 8), 0, (1, 1536, 1536)),     # a leading block: contiguous
    ((4, 6, 16, 8), 1, (4, 384, 768)),
    ((4, 6, 16, 8), 2, (24, 64, 128)),
    ((4, 6, 16, 8), 3, (384, 4, 8)),
    ((3, 1, 5), 2, (3, 2, 5)),                # unit dims drop out
    ((5,), None, (1, 5, 5)),
    ((), None, (1, 1, 1)),
])
def test_rows_of_runs_of_narrowed_views(shape, dim, want):
    t = torch.zeros(shape)
    if dim is not None:
        w = shape[dim] // 2
        t = t.narrow(dim, w, w)
    assert K.runs(t) == want
    rows, run, stride = want
    e = np.arange(t.numel())
    assert np.array_equal(t.storage_offset() + e // run * stride + e % run,
                          _true_offsets(t, torch.zeros(shape)))


def test_other_layouts_are_not_rows_of_runs():
    """A transposed tensor or a strided last axis is no rows-of-runs view:
    a gradient laid out so is copied once, a parameter or moment raises."""
    a = torch.zeros((6, 8))
    assert K.runs(a.t()) is None and K.runs(a[:, ::2]) is None
    assert K.runs(torch.zeros((4, 6, 8)).permute(1, 0, 2)) is None
    m, v = torch.zeros((8, 6)), torch.zeros((8, 6))
    g = torch.randn((6, 8)).t()
    row, keep = K.update_entry(g, torch.zeros((8, 6)), m, v, None)
    assert keep[0] is not g and keep[0].is_contiguous()
    assert torch.equal(keep[0], g) and row[K.F_G] == keep[0].data_ptr()
    with pytest.raises(ValueError, match="p must be rows"):
        K.update_entry(g, a.t(), m, v, None)
    with pytest.raises(ValueError, match="m must be rows"):
        K.update_entry(g, m, a.t(), v, None)


@pytest.mark.parametrize("shape,s_shape,dim,want", [
    ((4, 6, 16, 8), (), None, []),
    ((4, 6, 16, 8), (4, 1, 1, 1), None, [(768, 4, 1)]),
    ((4, 6, 16, 8), (4, 1, 16, 1), None, [(8, 16, 1), (768, 4, 16)]),
    ((4, 6, 16, 8), (4, 1, 16, 1), 1, [(8, 16, 1), (384, 4, 16)]),
    ((4, 6, 16, 8), (4, 1, 16, 1), 2, [(8, 8, 1), (384, 4, 16)]),
    ((4, 16, 8), (4, 16, 1), None, [(8, 64, 1)]),     # merged: contiguous
    ((4, 16, 8), (4, 16, 1), 2, [(4, 64, 1)]),
])
def test_scale_terms_per_row_of_the_last_axis(shape, s_shape, dim, want):
    """The terms of a 0-d scale, a per-layer gate, a per-layer × mask over
    an expert leaf and a masked matrix, whole and narrowed; every element's
    scale found by them is the broadcast scale's."""
    s = torch.arange(1, 1 + int(np.prod(s_shape)), dtype=torch.float32
                     ).reshape(s_shape)
    view = torch.broadcast_to(s, shape)
    if dim is not None:
        w = shape[dim] // 2
        view = view.narrow(dim, w, w)
    terms = K.scale_terms(view, view.shape)
    assert terms == want
    row = np.zeros(K.FIELDS, np.int64)
    row[K.F_N], row[K.F_S], row[K.F_NTERMS] = view.numel(), view.data_ptr(), \
        len(terms)
    for k, t in enumerate(terms):
        row[K.F_TERMS + 3 * k:K.F_TERMS + 3 * k + 3] = t
    assert torch.equal(s.flatten()[_scale_offsets(row, s)],
                       view.contiguous().flatten())


def test_scale_that_varies_along_the_last_axis_raises():
    with pytest.raises(ValueError, match="last axis"):
        K.scale_terms(torch.ones((4, 1, 8)), (4, 6, 8))
    with pytest.raises(ValueError, match="terms"):
        K.scale_terms(torch.ones((2, 1, 3, 1, 5, 1, 7, 1)),
                      (2, 2, 3, 2, 5, 2, 7, 4))


def test_offsets_are_64_bit():
    """An expert leaf of Moonlight's (4 × 64 × 2048 × 1408: m is 2.95 GB)
    and a leaf of 2^33 elements, on ``meta``: the table holds every count,
    stride and term exactly, past 32 bits, and the last element's offset is
    the view's own."""
    for shape, dim in (((4, 64, 2048, 1408), 1), ((4, 1 << 20, 1 << 12), 1)):
        p = torch.empty(shape, dtype=torch.bfloat16, device="meta")
        w = shape[dim] // 2
        pv = p.narrow(dim, w, w)
        m = torch.empty(pv.shape, device="meta")
        s = torch.empty((shape[0], 1, shape[2], 1)[:len(shape) - 1] + (1,),
                        device="meta")
        sv = torch.broadcast_to(s, shape).narrow(dim, w, w)
        row, _ = K.update_entry(pv, pv, m, m, sv)
        rows, run, stride = K.runs(pv)
        assert row.dtype == np.int64 and int(row[K.F_N]) == pv.numel()
        assert (int(row[K.F_RUN]), int(row[K.F_RS_P])) == (run, stride)
        assert int(row[K.F_RS_M]) == run
        last = pv.numel() - 1
        want = pv.storage_offset() + sum(
            (i - 1) * st for i, st in zip(pv.shape, pv.stride()))
        assert last // run * stride + last % run + pv.storage_offset() == want
        terms = K.scale_terms(sv, pv.shape)
        assert [tuple(row[K.F_TERMS + 3 * k:K.F_TERMS + 3 * k + 3])
                for k in range(len(terms))] == terms
    assert pv.numel() > 2 ** 32 and want > 2 ** 32


@pytest.mark.parametrize("which,dtype,err", [
    ("p", torch.float16, TypeError), ("g", torch.float64, TypeError),
    ("m", torch.bfloat16, TypeError), ("s", torch.float64, TypeError),
    ("shape", None, ValueError)])
def test_entry_raises_on_what_the_kernel_does_not_take(which, dtype, err):
    args = {"g": torch.zeros((4, 8)), "p": torch.zeros((4, 8)),
            "m": torch.zeros((4, 8)), "v": torch.zeros((4, 8)),
            "s": torch.ones(())}
    if which == "shape":
        args["m"] = torch.zeros((8, 4))
    else:
        args[which] = args[which].to(dtype)
    with pytest.raises(err):
        K.update_entry(**args)
    if which == "g":
        with pytest.raises(err):
            K.norm_entry(args["g"], False)


@pytest.mark.parametrize("shape,dim,s_shape,vector", [
    ((4, 16, 8), None, None, True),
    ((3, 5, 7), None, None, False),           # runs not a multiple of VEC
    ((4, 16, 8), 2, None, False),             # runs of 4
    ((4, 16, 8), 1, (4, 1, 1), True),
    ((4, 16, 4), None, (4, 16, 1), False),    # the scale changes every 4
])
def test_vector_path_only_where_eight_elements_share_a_run(shape, dim,
                                                           s_shape, vector):
    p = torch.zeros(shape)
    if dim is not None:
        w = shape[dim] // 2
        p = p.narrow(dim, w, w)
    m = torch.zeros(p.shape)
    s = None if s_shape is None else torch.ones(s_shape)
    if s is not None and dim is not None:
        s = torch.broadcast_to(s, shape).narrow(dim, shape[dim] // 2,
                                                shape[dim] // 2)
    row, _ = K.update_entry(p, p, m, m, s)
    assert bool(row[K.F_FLAGS] & K.VECTOR) == vector



def test_launch_counters_hold_the_two_kernels():
    """The norm's and the update's launchers are in the kernels' launch
    registry, so every path's per-kernel counts include them; a CPU step
    launches neither."""
    from repro_torch.kernels import launch_counters, launch_counts
    from repro_torch.optim.optimizer import adamw_init, adamw_update
    reg = launch_counters()
    assert reg["adamw_norm"] is K.adamw_norm_cuda
    assert reg["adamw_update"] is K.adamw_update_cuda
    before, elems = launch_counts(), K.adamw_update_cuda.elems
    p = {"w": torch.ones(4, 8)}
    adamw_update({"w": torch.full((4, 8), 0.5)}, p, adamw_init(p),
                 AdamWConfig())
    assert launch_counts() == before and K.adamw_update_cuda.elems == elems
