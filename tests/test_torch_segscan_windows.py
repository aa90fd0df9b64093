"""The window algorithm of the segmented-scan kernel (K4; the kernel builds
it for reach 16 and 32, the emulation holds it at shorter reaches too) and
the table its wrapper hands the kernel, on the CPU.

``csrc/segscan.cu`` cannot run without a card, so :func:`emulate` repeats
its algorithm in PyTorch at the kernel's own granularity: a warp is a
tensor of 32 lanes, a strip is ``windows`` windows of 32 rows walked in
order after the window before it, a step of the recurrence is one rotation
of the lanes (``__shfl_sync``) in which the lanes below ``d`` receive the
state the previous window had before that step, the flags are bit tests on
the 64-bit pair of this window's and the previous window's start masks
(``__ballot_sync``), and ``tot`` is read one window behind at an index found
with find-first-set on the end masks.  Rows outside ``[0, P)`` read as the
recurrences' own fill.

The emulation is held bit for bit (``hi`` and ``tot`` on every row) against
``seg_scans_plain`` and the JAX package's ``_seg_cumsum`` /
``_fill_from_end``, and against ``seg_scans_pallas`` in interpret mode
(``tot`` on live rows, the rows that kernel defines) where P is a multiple
of 128: at the four calls of a compact frame, at P that is no multiple of
32, at a P shorter than a strip, at several strip lengths, with runs that
cross window and strip edges, a dead tail, -0.0 values and bool and i32
columns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dspmap_tpu.ops.pallas.segscan as sg
from dspmap_tpu.ops import compact as jc
from dspmap_tpu_torch import kernels
from dspmap_tpu_torch.ops import compact as tc

torch.set_num_threads(2)

LANES = 32
STEPS = 5  # d = 1, 2, 4, 8, 16


def _ballot(flags) -> int:
    return sum(1 << lane for lane in range(LANES) if bool(flags[lane]))


def _ffs(x: int) -> int:
    return (x & -x).bit_length()


def emulate(cols, is_start, is_end, max_run, n_tot, windows):
    """``(hi [C, P], tot [n_tot, P])`` by the kernel's window walk, one warp
    a (strip of ``windows`` windows, column)."""
    reach = tc._reach(max_run)
    assert reach <= LANES
    P = cols[0].shape[0]
    lanes = torch.arange(LANES)
    n_strips = -(-(-(-P // LANES)) // windows)
    reach_mask = (1 << reach) - 1
    hi = torch.full((len(cols), P), float("nan"))
    tot = torch.full((n_tot, P), float("nan"))
    for c, col in enumerate(cols):
        x_all = col.to(torch.float32)  # the kernel's typed load
        with_tot = c < n_tot
        for strip in range(n_strips):
            row0 = (strip * windows - 1) * LANES
            before = [torch.zeros(LANES) for _ in range(STEPS)]
            hi_prev = torch.zeros(LANES)
            ms, me = [], []
            for k in range(windows + 2):
                if k == windows + 1 and not with_tot:
                    break
                g = row0 + LANES * k + lanes
                inside = (g >= 0) & (g < P)
                gi = g.clamp(0, P - 1)
                cur = torch.where(inside, x_all[gi], torch.zeros(()))
                ms.append(_ballot(~inside | is_start[gi]))
                me.append(_ballot(inside & is_end[gi]) if with_tot else 0)
                starts = (ms[k] << 32) | (ms[k - 1] if k else 0xffffffff)
                for j in range(STEPS):
                    d = 1 << j
                    if d >= reach:
                        break
                    if k == 0 and 2 * d >= reach:
                        # the window before the strip is walked for its
                        # states before each step: its last step is left out
                        before[j] = cur
                        break
                    b = torch.tensor([
                        (starts >> (33 + lane - d)) & ((1 << d) - 1) != 0
                        for lane in range(LANES)])
                    give = torch.where(lanes + d < LANES, cur, before[j])
                    got = give[(lanes - d) % LANES]
                    before[j] = cur
                    cur = torch.where(b, cur, cur + got)
                if 1 <= k <= windows:
                    hi[c, g[inside]] = cur[inside]
                if with_tot and k >= 2:
                    ends = (me[k] << 32) | me[k - 1]
                    frm = []
                    for lane in range(LANES):
                        e = (ends >> lane) & reach_mask
                        frm.append(lane + (_ffs(e) - 1 if e else reach - 1))
                    frm = torch.tensor(frm)
                    val = torch.where(frm < LANES, hi_prev[frm % LANES],
                                      cur[frm % LANES])
                    gt = g - LANES
                    ok = (gt >= 0) & (gt < P)
                    tot[c, gt[ok]] = val[ok]
                hi_prev = cur
    return hi, tot


def _inputs(P, C, max_run, seed, typed=False):
    """Sorted runs of 1..max_run rows, five rows of one run repeated further
    on, a dead tail of one long run, some -0.0 values; with ``typed`` the
    first column is bool and the last i32."""
    rng = np.random.default_rng(seed)
    key = np.repeat(np.arange(P), rng.integers(1, max_run + 1, P))[:P]
    if P > 64:
        key[P // 3:P // 3 + 5] = key[7]
    key[-(P // 10 + 1):] = 10**6
    ne = key[1:] != key[:-1]
    is_start = np.concatenate([[True], ne])
    is_end = np.concatenate([ne, [True]]) & (key < 10**6)
    x = rng.uniform(0, 1, (C, P)).astype(np.float32)
    x[:, ::97] = -0.0
    cols = [torch.from_numpy(c) for c in x]
    if typed:
        cols[0] = torch.from_numpy(rng.random(P) < 0.6)
        cols[-1] = torch.from_numpy(rng.integers(0, 9, P).astype(np.int32))
    return (torch.from_numpy(key < 10**6), torch.from_numpy(is_start),
            torch.from_numpy(is_end), cols)


def _bits(x):
    return x.contiguous().view(torch.int32)


#: (P, columns, n_tot, max_run, windows a strip, typed columns): the four
#: calls of a compact frame at large_urban's slot depth (reach 32, 32, 16,
#: 16) with the kernel's strip of 3 windows, then ragged P, a P shorter than
#: a strip, other strip lengths, shorter reaches
CASES = [
    (2048, 7, 2, 20, 3, True), (2048, 2, 2, 20, 3, True),
    (2048, 4, 0, 10, 3, True), (2048, 1, 0, 10, 3, False),
    (1000, 3, 2, 20, 3, False), (1027, 2, 1, 32, 4, False),
    (77, 2, 2, 20, 3, False), (640, 2, 2, 17, 2, False),
    (513, 2, 1, 3, 16, False), (300, 1, 1, 1, 8, False),
]


@pytest.mark.parametrize(
    "P,C,n_tot,max_run,windows,typed", CASES,
    ids=[f"P{p}-C{c}-tot{n}-run{r}-strip{w}" for p, c, n, r, w, _ in CASES])
def test_window_walk_bit_equal_to_plain_and_jax(P, C, n_tot, max_run, windows,
                                                typed):
    live, st, en, cols = _inputs(P, C, max_run, seed=P + C + max_run, typed=typed)
    hi, tot = emulate(cols, st, en, max_run, n_tot, windows)
    his_p, tots_p = tc.seg_scans_plain(cols, st, en, max_run, n_tot)
    assert len(his_p) == C and len(tots_p) == n_tot
    for c in range(C):
        assert torch.equal(_bits(hi[c]), _bits(his_p[c])), f"hi {c}"
    for c in range(n_tot):
        assert torch.equal(_bits(tot[c]), _bits(tots_p[c])), f"tot {c}"

    X = np.stack([c.to(torch.float32).numpy() for c in cols], -1)
    hi_x = np.asarray(jc._seg_cumsum(jnp.asarray(X), jnp.asarray(st.numpy()),
                                     max_run))
    np.testing.assert_array_equal(hi.numpy().view(np.int32),
                                  hi_x.T.view(np.int32))
    if n_tot:
        tot_x = np.asarray(jc._fill_from_end(
            jnp.asarray(hi_x[:, :n_tot]), jnp.asarray(en.numpy()), max_run))
        np.testing.assert_array_equal(tot.numpy().view(np.int32),
                                      tot_x.T.view(np.int32))
    if P % 128:
        return  # the Pallas kernel tiles P by 128
    old = sg.INTERPRET
    sg.INTERPRET = True
    try:
        his_k, tots_k = sg.seg_scans_pallas(
            [jnp.asarray(c.to(torch.float32).numpy()) for c in cols],
            jnp.asarray(st.numpy()), jnp.asarray(en.numpy()), max_run, n_tot)
    finally:
        sg.INTERPRET = old
    for c in range(C):
        np.testing.assert_array_equal(hi[c].numpy(), np.asarray(his_k[c]))
    for c in range(n_tot):
        np.testing.assert_array_equal(tot[c][live].numpy(),
                                      np.asarray(tots_k[c])[live.numpy()])


def test_closed_forms_of_flags_and_fill():
    """What the kernel takes in closed form instead of stepping: before step
    d the flag of row i is "a run starts in rows (i - d, i]", and the
    backward fill gives hi at the first end row in [i, i + reach), or
    hi[i + reach - 1] where there is none (0 past the last row)."""
    P, max_run = 400, 20
    reach = tc._reach(max_run)
    _, st, en, cols = _inputs(P, 1, max_run, seed=9)
    b, d = st.clone(), 1
    while d < reach:
        want = torch.tensor([bool(st[max(i - d + 1, 0):i + 1].any())
                             or i - d + 1 < 0 for i in range(P)])
        assert torch.equal(b, want), d
        b = b | tc._shift(b, d, True, down=True)
        d *= 2
    hi = tc.seg_cumsum_plain(cols[0], st, max_run)
    tot = tc.fill_from_end_plain(hi, en, max_run)
    for i in range(P):
        ends = torch.nonzero(en[i:i + reach])
        j = i + (int(ends[0]) if len(ends) else reach - 1)
        want = hi[j] if j < P else torch.zeros(())
        assert _bits(tot[i:i + 1]) == _bits(want.reshape(1)), i


def _spy(monkeypatch):
    seen = {"checks": []}
    monkeypatch.setattr(
        kernels, "check_cuda",
        lambda *a, **kw: seen["checks"].append((a, kw)))
    monkeypatch.setattr(kernels, "launch",
                        lambda *a: seen.update(zip(("name", "p", "f", "i"), a)))
    return seen


@pytest.mark.parametrize("C,n_tot,max_run", [(7, 2, 20), (2, 2, 20),
                                             (4, 0, 10), (1, 0, 10)])
def test_wrapper_hands_the_kernel_its_column_table(C, n_tot, max_run,
                                                   monkeypatch):
    """What ``seg_scans_cuda`` gives ``csrc/segscan.cu``: the columns where
    they lie (no stack, no cast) with a type code each, the two bool flag
    vectors, and one allocation of ``C + n_tot`` rows of which ``hi`` and
    ``tot`` are views; one ``check_cuda`` over all the inputs."""
    P = 256
    _, st, en, cols = _inputs(P, C, max_run, seed=C, typed=True)
    if C > 2:
        cols[1] = cols[1].to(torch.float32).to(torch.uint8)
    seen = _spy(monkeypatch)
    hi, tot = tc.seg_scans_cuda(cols, st, en, max_run, n_tot)
    assert seen["name"] == "seg_scans" and seen["f"] == ()
    ptrs = seen["p"]
    assert len(ptrs) == C + 3
    for got, col in zip(ptrs, cols):
        assert got is col
    assert ptrs[C] is st and ptrs[C + 1] is en
    out = ptrs[C + 2]
    assert out.shape == (C + n_tot, P) and out.dtype == torch.float32
    assert out.untyped_storage().nbytes() == (C + n_tot) * P * 4
    assert len(hi) == C and hi[0].data_ptr() == out.data_ptr()
    assert len(tot) == n_tot
    assert n_tot == 0 or tot[0].data_ptr() == out.data_ptr() + C * P * 4
    assert all(h.shape == (P,) and h.is_contiguous() for h in hi + tot)
    code = {torch.float32: 0, torch.bool: 1, torch.uint8: 1, torch.int32: 2}
    assert tuple(seen["i"][:4 + C]) == (C, P, n_tot, tc._reach(max_run),
                                        *[code[c.dtype] for c in cols])
    (args, kw), = seen["checks"]
    assert len(args) == C + 2 and kw == {"shape": (P,)}


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    _, st, en, cols = _inputs(128, 2, 10, seed=1)
    seen = _spy(monkeypatch)
    with pytest.raises(ValueError):
        tc.seg_scans_cuda(cols * 5, st, en, 10, 0)  # ten columns
    with pytest.raises(ValueError):
        tc.seg_scans_cuda(cols, st, en, 10, 3)
    with pytest.raises(ValueError):
        tc.seg_scans_cuda(cols, st, en, tc.KERNEL_MAX_REACH + 1, 0)
    with pytest.raises(TypeError):
        tc.seg_scans_cuda([cols[0], cols[1].double()], st, en, 10, 0)
    with pytest.raises(TypeError):
        tc.seg_scans_cuda(cols, st.to(torch.uint8), en, 10, 0)
    assert "name" not in seen  # nothing was launched
    # the real check refuses CPU tensors, so nothing falls back
    monkeypatch.undo()
    before = dict(kernels.LAUNCHES)
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        tc.seg_scans_cuda(cols, st, en, 10, 0)
    assert kernels.LAUNCHES == before


def test_blocks_feed_the_run_end_tables():
    """``seg_scans`` returns ``hi [C, P]`` and ``tot [n_tot, P]`` whose
    rows are ``seg_scans_plain``'s columns, and ``_ends_table`` fed that
    block equals ``segment_table`` on the same columns."""
    P, n_cells = 900, 40
    rng = np.random.default_rng(3)
    cell = torch.from_numpy(np.sort(rng.integers(0, n_cells, P)).astype(np.int32))
    valid = torch.from_numpy(rng.random(P) < 0.9)
    cols = [torch.from_numpy(rng.random(P).astype(np.float32)), valid]
    key = torch.where(valid, cell, n_cells)
    prv, nxt = tc._run_bounds(key)
    masked = [torch.where(valid, cols[0], torch.zeros(())), valid]
    hi, tot = tc.seg_scans(masked, prv, nxt, 64, 1)
    his, tots = tc.seg_scans_plain(masked, prv, nxt, 64, 1)
    assert hi.shape == (2, P) and tot.shape == (1, P)
    for a, b in zip(list(hi) + list(tot), his + tots):
        assert torch.equal(_bits(a), _bits(b))
    want = tc.segment_table(cell, valid, cols, n_cells)
    got = tc._ends_table(hi, key, nxt & (key < n_cells), n_cells)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ref = tc._scatter_add_cols(cell, valid, cols, n_cells)
    torch.testing.assert_close(want[0], ref[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(want[1], ref[1])  # counts are exact
