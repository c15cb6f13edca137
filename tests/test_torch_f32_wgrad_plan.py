"""The float32 weight gradients' launch plan and the arithmetic of its
routes, on the CPU (csrc/f32_wgrad.cuh runs only on the card; what
chooses its route, lays out its outputs and fixes its order of summation
is checked here).

- ``f32_wgrad_plan`` names the narrow or the wgmma route for every padded
  width of tests/test_torch_scan_limits.py and every K, never the tiled
  kernel; the main path's launches take the narrow route at the spirals
  widths and the wgmma route at D = H = 256 and at D = 32, H = 256, with
  the CTAs, splits and stage rows that their designs call for.
- Each route's index arithmetic, transcribed from the kernels, writes
  every float of every partial exactly once, in the layout that
  ``unpack_partial`` reads.
- A torch emulation of each route's arithmetic (its row ranges and
  partials; the narrow route's FMA chains in row order, its groups of
  rows and their sum in group order; the wgmma route's 32-row stages, the
  tf32_round hi/lo split, three passes into a fresh accumulator each
  stage and the f32 promotion, and its bias sums by quarters of a stage's
  rows) holds ``gtf_wgrad_ref`` within chip_smoke.py's BWD_TOL, normalised
  as its ``max_norm_err``, at Weizmann's K = 25 row count (60,000 rows)
  at the spirals widths; and lies within 1e-6 of a float64 reference in
  relative Frobenius norm, as close as ``gtf_wgrad_ref`` itself.
"""

import numpy as np
import pytest
import torch

from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan as tscan

from test_torch_scan_limits import K_CASES, _widths

BWD_TOL = dict(rtol=1e-3, atol=1e-3)  # chip_smoke.py, on normalised values
# Emulated routes and gtf_wgrad_ref against float64, relative Frobenius
# norm: float32 sums of 60,000 rows lie near 1e-7 here.
F64_RFRO = 1e-6

# name -> ((D, H) padded, rows) of the main path's float32 weight-gradient
# launches, and the route the plan must give them.
MAIN_PATH = {
    # Spirals (z = 5 run as 8, h = 20): T = 100, 300 columns, K = 1 and 25;
    # the step's smoothing pass has K = 1 too.
    "spirals_k1": ((8, 20), 99 * 300, "narrow"),
    "spirals_k25": ((8, 20), 99 * 25 * 300, "narrow"),
    # Weizmann: T = 25, 100 columns, K = 1 and 25; K = 50 (phase 16 (b)).
    "weizmann_k1": ((256, 256), 24 * 100, "wgmma"),
    "weizmann_k25": ((256, 256), 24 * 25 * 100, "wgmma"),
    "weizmann_k50": ((256, 256), 24 * 50 * 100, "wgmma"),
    # VidTIMIT: T = 80, 75 columns.
    "vidtimit_k1": ((256, 256), 79 * 75, "wgmma"),
    "vidtimit_k25": ((256, 256), 79 * 25 * 75, "wgmma"),
    # Phase 16 (d): z = 32 beside h = 256, K = 25.
    "narrow_z_wide_h": ((32, 256), 24 * 25 * 100, "wgmma"),
}


def _layout(d, h):
    """Offsets of the partial's gradients (the kernels' ``layout``)."""
    la = 2 * h + d
    o = {"dw1": 0, "db1": d * la}
    o["dwg2"] = o["db1"] + la
    o["dbg2"] = o["dwg2"] + h * d
    o["dwn2"] = o["dbg2"] + d
    o["dbn2"] = o["dwn2"] + h * d
    o["dws"] = o["dbn2"] + d
    o["dbs"] = o["dws"] + d * d
    assert o["dbs"] + d == tscan.partial_size(d, h)
    return o


def _check_plan(plan, d, h, n_rows):
    assert plan["route"] in ("narrow", "wgmma")
    stages = -(-n_rows // plan["rows"])
    assert plan["stages"] == stages
    assert 1 <= plan["splits"] <= max(stages, 1)
    if plan["route"] == "narrow":
        blocks = tscan.narrow_blocks(d, h)
        assert plan["chunks"] * plan["per_chunk"] >= blocks
        assert plan["per_chunk"] * plan["groups"] <= plan["threads"]
        assert plan["threads"] % 32 == 0
        assert plan["threads"] <= tscan.WGRAD_NARROW_THREADS
        assert plan["smem"] <= tscan.F32_SMEM_LIMIT
        assert plan["ctas"] == plan["chunks"] * plan["splits"]
        assert plan["waves"] == 1
    else:
        assert plan["ctas"] == plan["units"] * plan["splits"]
        assert plan["waves"] <= max(tscan.WGRAD_MAX_WAVES,
                                    -(-plan["units"] // tscan.F32_SMS))
        assert plan["smem"] <= tscan.F32_SMEM_LIMIT


@pytest.mark.parametrize("k", (1, 25, 50, 256))
def test_plan_names_a_route_for_every_width(k):
    """A route for every padded width 1-1,024 of the scan tests (beside 256,
    equal widths, the wide transitions) and every pair up to 32 at T = 25,
    100 columns: the narrow route exactly where D and H are at most
    WGRAD_NARROW_MAX_WIDTH and its blocks at most WGRAD_NARROW_MAX_BLOCKS,
    the wgmma route everywhere else, never the tiled kernel."""
    assert k in K_CASES
    seen = set()
    small = [(d, h) for d in range(1, 33) for h in range(1, 33)]
    for d, h in _widths() + small:
        dp, hp = tscan._check_sizes(k, d, h)
        if (dp, hp) in seen:
            continue
        seen.add((dp, hp))
        n_rows = 24 * k * 100
        plan = tscan.f32_wgrad_plan(dp, hp, n_rows)
        narrow = (max(dp, hp) <= tscan.WGRAD_NARROW_MAX_WIDTH
                  and tscan.narrow_blocks(dp, hp)
                  <= tscan.WGRAD_NARROW_MAX_BLOCKS)
        assert plan["route"] == ("narrow" if narrow else "wgmma"), (dp, hp)
        _check_plan(plan, dp, hp, n_rows)


@pytest.mark.parametrize("name", sorted(MAIN_PATH))
def test_main_path_takes_a_new_route(name):
    (d, h), n_rows, route = MAIN_PATH[name]
    plan = tscan.f32_wgrad_plan(d, h, n_rows)
    assert plan["route"] == route, plan
    _check_plan(plan, d, h, n_rows)


def test_plan_numbers_at_the_main_shapes():
    """The narrow route at the spirals widths: one 4 x 4 block of outputs
    a thread (66 blocks: 24 of dW1, 10 each of dWg2 and dWn2, 4 of dWs, 18
    of bias sums) in 7 groups of rows, 480 threads, 64-row stages of 32 KB,
    one wave of 264 CTAs (two an SM) at both K. The wgmma route at D = H =
    256: 24 units (dW1's 768 x 256 as 6 x 2, each other product 2 x 2, 128
    output rows by 128 columns a unit), 32-row stages, 11 splits: 264 CTAs,
    two whole waves of one CTA an SM (5 splits would leave 12 SMs idle);
    at D = 32, H = 256 10 units (32- and 128-column tiles) in 13 splits,
    one wave of 130."""
    for n_rows in (99 * 300, 99 * 25 * 300):
        p = tscan.f32_wgrad_plan(8, 20, n_rows)
        assert tscan.narrow_blocks(8, 20) == 66
        assert (p["chunks"], p["per_chunk"], p["groups"], p["threads"]) == (
            1, 66, 7, 480)
        assert (p["rows"], p["smem"], p["splits"], p["ctas"]) == (
            64, 3 * 32768, 264, 264)
    for n_rows in (2400, 60000, 5925, 148125):
        p = tscan.f32_wgrad_plan(256, 256, n_rows)
        assert (p["units"], p["rows"], p["splits"], p["ctas"],
                p["waves"]) == (24, 32, 11, 264, 2)
        assert p["smem"] == 4 * 32768 + 65536 + 1024 <= tscan.F32_SMEM_LIMIT
    p = tscan.f32_wgrad_plan(32, 256, 60000)
    assert (p["units"], p["splits"], p["ctas"], p["waves"]) == (10, 13, 130,
                                                                 1)
    # The threshold, where the card's timings cross (WGRAD_NARROW_MAX_BLOCKS):
    # narrow at D = 32, H = 16 and D = 8, H = 32; wgmma at D = 24, H = 32
    # and D = H = 28, 32.
    for (d, h), route in (((32, 16), "narrow"), ((8, 32), "narrow"),
                          ((24, 32), "wgmma"), ((28, 28), "wgmma"),
                          ((32, 32), "wgmma")):
        assert tscan.f32_wgrad_plan(d, h, 60000)["route"] == route, (d, h)
    assert [tscan.narrow_blocks(d, h) for d, h in ((32, 16), (24, 32))] == [
        296, 304]


def test_named_routes():
    """A route named by the caller replaces the plan's: the narrow route at
    wide widths cuts its blocks into chunks of CTAs; the wgmma route takes
    the narrowest widths; the tiled kernel keeps its 528-CTA split; a
    narrow stage no CTA holds raises, and so does an unknown route."""
    p = tscan._f32_wgrad_plan(256, 256, 60000, "narrow")
    assert p["route"] == "narrow" and p["chunks"] > 1
    assert p["chunks"] * p["per_chunk"] >= tscan.narrow_blocks(256, 256)
    assert p["threads"] <= tscan.WGRAD_NARROW_THREADS
    assert p["smem"] <= tscan.F32_SMEM_LIMIT and p["waves"] == 1
    p = tscan._f32_wgrad_plan(8, 20, 60000, "wgmma")
    assert (p["route"], p["units"]) == ("wgmma", 4)
    p = tscan._f32_wgrad_plan(256, 256, 60000, "tiled")
    assert p == {"route": "tiled", "splits": tscan.wgrad_splits(256, 256)}
    assert tscan._f32_wgrad_plan(8, 20, 100) == tscan.f32_wgrad_plan(8, 20,
                                                                     100)
    with pytest.raises(ValueError):
        tscan._f32_wgrad_plan(4096, 4096, 100, "narrow")
    with pytest.raises(ValueError):
        tscan._f32_wgrad_plan(8, 20, 100, "column")
    for name in ("launches",) + tuple("launches_" + r
                                      for r in tscan.WGRAD_ROUTES):
        assert isinstance(getattr(tscan.gtf_wgrad_cuda, name), int)


# ---------------------------------------------------------------------------
# The kernels' index arithmetic
# ---------------------------------------------------------------------------

def _narrow_block(b, d, h):
    """The kernel's ``narrow_block``: (x section (0 zs, 1 xs, -1 bias), x
    column, y column, row length, output offset)."""
    la = 2 * h + d
    d4, h4, l4 = d // 4, h // 4, la // 4
    o = _layout(d, h)
    if b < d4 * l4:
        i, j = divmod(b, l4)
        return 0, 4 * i, 4 * j, la, o["dw1"] + 4 * i * la + 4 * j
    b -= d4 * l4
    if b < 2 * h4 * d4:
        p, c = divmod(b, h4 * d4)
        i, j = divmod(c, d4)
        return (1, p * h + 4 * i, la + p * d + 4 * j, d,
                o["dwn2" if p else "dwg2"] + 4 * i * d + 4 * j)
    b -= 2 * h4 * d4
    if b < d4 * d4:
        i, j = divmod(b, d4)
        return 1, 2 * h + 4 * i, la + 2 * d + 4 * j, d, o["dws"] + 4 * i * d + 4 * j
    c = 4 * (b - d4 * d4)
    out = (o["db1"] + c if c < la else o["dbg2"] + c - la if c < la + d
           else o["dbn2"] + c - la - d if c < la + 2 * d
           else o["dbs"] + c - la - 2 * d)
    return -1, 0, c, 0, out


def _wgmma_units(d, h):
    """The kernel's jobs and units: (a_col, b_map, b_col, M, N, bn, out,
    bias) per product, and per unit (job, m0, n0)."""
    la = 2 * h + d
    o = _layout(d, h)
    jobs = [(0, 0, 0, la, d, tscan._tile_width(d), o["dw1"], o["db1"]),
            (la, 1, 0, d, h, tscan._tile_width(h), o["dwg2"], o["dbg2"]),
            (la + d, 1, h, d, h, tscan._tile_width(h), o["dwn2"], o["dbn2"]),
            (la + 2 * d, 1, 2 * h, d, d, tscan._tile_width(d), o["dws"],
             o["dbs"])]
    assert [j[3:5] for j in jobs] == list(tscan._wgmma_jobs(d, h))
    units = []
    for j, (_, _, _, m, n, bn, _, _) in enumerate(jobs):
        mt = -(-m // tscan.WGRAD_UNIT_ROWS)
        for u in range(mt * -(-n // bn)):
            units.append((j, (u % mt) * tscan.WGRAD_UNIT_ROWS, (u // mt) * bn))
    return jobs, units


@pytest.mark.parametrize("d,h", [(4, 4), (8, 20), (12, 20), (32, 32), (64, 64),
                                 (32, 256), (256, 256), (44, 36)])
def test_routes_write_every_partial_float_once(d, h):
    """Each route's stores, transcribed from the kernels, cover a partial:
    every float written by exactly one thread (the narrow route's group-0
    threads of every chunk; the wgmma route's accumulator fragments and the
    first column tile's bias lanes), each x and y column read inside its
    row."""
    size = tscan.partial_size(d, h)
    la, ly = 2 * h + d, 2 * h + 4 * d
    hits = np.zeros(size, np.int64)
    for b in range(tscan.narrow_blocks(d, h)):
        sec, xc, yc, ld, out = _narrow_block(b, d, h)
        assert 0 <= yc and yc + 4 <= ly
        if sec < 0:
            hits[out:out + 4] += 1
            continue
        assert xc + 4 <= (d if sec == 0 else la)
        for a in range(4):
            hits[out + a * ld:out + a * ld + 4] += 1
    assert (hits == 1).all(), np.flatnonzero(hits != 1)[:10]
    plan = tscan._f32_wgrad_plan(d, h, 1000, "narrow")
    assert plan["chunks"] * plan["per_chunk"] >= tscan.narrow_blocks(d, h)

    jobs, units = _wgmma_units(d, h)
    assert len(units) == tscan._wgmma_wgrad_plan(d, h, 1000)["units"]
    hits[:] = 0
    for j, m0, n0 in units:
        a_col, _, b_col, m_dim, n_dim, bn, out, bias = jobs[j]
        m = np.arange(m0, min(m0 + tscan.WGRAD_UNIT_ROWS, m_dim))
        n = np.arange(n0, min(n0 + bn, n_dim))
        np.add.at(hits, (out + n[:, None] * m_dim + m[None, :]).ravel(), 1)
        if n0 == 0:
            np.add.at(hits, bias + m, 1)
    assert (hits == 1).all(), np.flatnonzero(hits != 1)[:10]


def test_partial_layout_round_trips():
    """A partial in the kernels' layout, unpacked: each gradient in
    PyTorch's layout (dW1's (in, out) block transposed into gate_1,
    nonlin_1, z_lin)."""
    d, h = 8, 20
    la = 2 * h + d
    o = _layout(d, h)
    flat = torch.arange(tscan.partial_size(d, h), dtype=torch.float32)
    g = tscan.unpack_partial(flat, d, h)
    dw1 = flat[:d * la].reshape(d, la).t()
    assert torch.equal(torch.cat([g[n]["w"] for n in
                                  ("gate_1", "nonlin_1", "z_lin")]), dw1)
    assert torch.equal(torch.cat([g[n]["b"] for n in
                                  ("gate_1", "nonlin_1", "z_lin")]),
                       flat[o["db1"]:o["db1"] + la])
    for name, w, b in (("gate_2", "dwg2", "dbg2"), ("nonlin_2", "dwn2",
                                                     "dbn2")):
        assert torch.equal(g[name]["w"],
                           flat[o[w]:o[w] + h * d].reshape(h, d).t())
        assert torch.equal(g[name]["b"], flat[o[b]:o[b] + d])
    assert torch.equal(g["z_to_std"]["w"],
                       flat[o["dws"]:o["dws"] + d * d].reshape(d, d).t())
    assert torch.equal(g["z_to_std"]["b"], flat[o["dbs"]:])


# ---------------------------------------------------------------------------
# The routes' arithmetic
# ---------------------------------------------------------------------------

def _products(z, xs, ys, d, h):
    """(x, y) of the four products at padded widths, then the bias sums'
    y (x None)."""
    la = 2 * h + d
    return [(z, ys[:, :la]), (xs[:, :h], ys[:, la:la + d]),
            (xs[:, h:2 * h], ys[:, la + d:la + 2 * d]),
            (xs[:, 2 * h:], ys[:, la + 2 * d:]), (None, ys)]


def _to_partials(sums, d, h):
    """(splits, partial_size) from per-product (splits, Fx, Fy) sums and the
    (splits, ly) bias sums, in the kernels' layout."""
    la = 2 * h + d
    o = _layout(d, h)
    part = torch.zeros((sums[0].shape[0], tscan.partial_size(d, h)))
    for (w, b, lo, hi), s in zip((("dw1", "db1", 0, la),
                                  ("dwg2", "dbg2", la, la + d),
                                  ("dwn2", "dbn2", la + d, la + 2 * d),
                                  ("dws", "dbs", la + 2 * d, la + 3 * d)),
                                 sums[:4]):
        part[:, o[w]:o[w] + s[0].numel()] = s.reshape(s.shape[0], -1)
        part[:, o[b]:o[b] + hi - lo] = sums[4][:, lo:hi]
    return part


def _ranges(plan, n_rows):
    """Each split's rows: its stages, s0 = split stages / splits (the
    kernels' division)."""
    st, sp, rows = plan["stages"], plan["splits"], plan["rows"]
    return [(s * st // sp * rows, min(n_rows, (s + 1) * st // sp * rows))
            for s in range(sp)]


def emulate_narrow(z, xs, ys, d, h, plan):
    """The narrow route's partials: in each split's range, group g takes
    the rows whose place in their stage is g modulo ``groups``, in row
    order, each step one FMA (the product exact in float64, one rounding
    to float32) or, for the bias sums, one float32 add; the groups' sums
    added in group order."""
    n_rows, rows, groups = z.shape[0], plan["rows"], plan["groups"]
    seqs = []
    for r0, r1 in _ranges(plan, n_rows):
        r = np.arange(r0, r1)
        seqs += [r[(r % rows) % groups == g] for g in range(groups)]
    n = max(len(s) for s in seqs)
    idx = torch.tensor(np.stack([np.pad(s, (0, n - len(s)),
                                        constant_values=n_rows)
                                 for s in seqs]))  # past the end: a zero row
    sums = []
    for x, y in _products(z, xs, ys, d, h):
        y0 = torch.cat([y, y.new_zeros(1, y.shape[1])])
        if x is None:
            acc = torch.zeros(len(seqs), y.shape[1])
            for t in range(n):
                acc = acc + y0[idx[:, t]]
        else:
            x0 = torch.cat([x, x.new_zeros(1, x.shape[1])]).double()
            acc = torch.zeros(len(seqs), x.shape[1], y.shape[1])
            for t in range(n):
                prod = x0[idx[:, t]][:, :, None] * y0.double()[idx[:, t]][:, None]
                acc = (acc.double() + prod).float()
        acc = acc.reshape(plan["splits"], groups, *acc.shape[1:])
        tot = acc[:, 0]
        for g in range(1, groups):
            tot = tot + acc[:, g]
        sums.append(tot)
    return _to_partials(sums, d, h)


def _tf32_split(x):
    hi = tscan.tf32_round(x)
    return hi, tscan.tf32_round(x - hi)


def emulate_wgmma(z, xs, ys, d, h, plan):
    """The wgmma route's partials: each split's 32-row stages, in order;
    each stage's product lo(A)^T hi(B) + hi(A)^T lo(B) + hi(A)^T hi(B) of
    the tf32_round split into a fresh float32 sum, added to the running
    float32 sum; the bias sums of A's columns by the four lanes q of a row,
    each adding rows 8 k + 2 q and 8 k + 2 q + 1 (k = 0..3) of every stage
    in order, then (q0 + q1) + (q2 + q3)."""
    n_rows = z.shape[0]
    st = plan["stages"]
    bounds = [(r0 // 32, -(-r1 // 32)) for r0, r1 in _ranges(plan, n_rows)]
    n = max(b - a for a, b in bounds)

    def staged(v):  # (stages + 1, 32, F): zero rows past R, a zero stage
        pad = v.new_zeros((st + 1) * 32 - v.shape[0], v.shape[1])
        return torch.cat([v, pad]).reshape(st + 1, 32, -1)

    def stage_idx(t):
        return torch.tensor([a + t if a + t < b else st for a, b in bounds])
    sums = []
    for x, y in _products(z, xs, ys, d, h)[:4]:
        a_st, b_st = staged(y), staged(x)
        tot = torch.zeros(len(bounds), y.shape[1], x.shape[1])
        for t in range(n):
            i = stage_idx(t)
            ah, al = _tf32_split(a_st[i])
            bh, bl = _tf32_split(b_st[i])
            acc = (al.transpose(1, 2) @ bh + ah.transpose(1, 2) @ bl
                   + ah.transpose(1, 2) @ bh)
            tot = tot + acc
        sums.append(tot.transpose(1, 2))  # (in, out)
    y_st = staged(ys)
    quarters = torch.zeros(len(bounds), 4, ys.shape[1])
    order = torch.tensor([[8 * k + 2 * q + e for k in range(4)
                           for e in range(2)] for q in range(4)])
    for t in range(n):
        rows = y_st[stage_idx(t)][:, order]  # (splits, 4, 8, ly)
        for e in range(8):
            quarters = quarters + rows[:, :, e]
    sums.append((quarters[:, 0] + quarters[:, 1])
                + (quarters[:, 2] + quarters[:, 3]))
    return _to_partials(sums, d, h)


def _rows(d, h, t_max, k, b_dim, seed):
    """z_traj (T, K, B, D) and the backward's rows xs, ys, made with
    numpy: normal values with a mean, so that long sums grow."""
    rng = np.random.RandomState(seed)
    n_rows = (t_max - 1) * k * b_dim
    f = lambda *s: torch.tensor((rng.randn(*s) + 0.3).astype(np.float32))  # noqa: E731
    return f(t_max, k, b_dim, d), f(n_rows, 2 * h + d), f(n_rows, 2 * h + 4 * d)


def _max_norm_ok(got, exp):
    scale = exp.abs().max().item() + 1e-6
    g, e = got / scale, exp / scale
    return bool(torch.all((g - e).abs() <= BWD_TOL["atol"]
                          + BWD_TOL["rtol"] * e.abs()))


def _rfro(got, exp):
    return ((got.double() - exp).norm() / exp.norm()).item()


# Weizmann's K = 25 row count (T = 25, K = 25, B = 100: 60,000 rows) at the
# spirals widths (D = 5 padded to 8, H = 20), and unaligned widths at fewer
# rows; each route named, whatever the plan gives the shape.
@pytest.mark.parametrize("route", ["narrow", "wgmma"])
@pytest.mark.parametrize("d,h,t_max,k,b_dim", [(5, 20, 25, 25, 100),
                                               (7, 13, 10, 25, 13)])
def test_route_arithmetic_holds_the_plain_version(route, d, h, t_max, k,
                                                  b_dim):
    z_traj, xs, ys = _rows(d, h, t_max, k, b_dim, seed=d + 10 * k)
    n_rows = xs.shape[0]
    dp, hp = tscan._padded(d), tscan._padded(h)
    # The rows as the wrapper pads them (gtf_wgrad_cuda).
    z = tscan._pad_last(z_traj, dp).reshape(-1, dp)[:n_rows]
    xp = tscan._pad_blocks(xs, (h, h, d), (hp, hp, dp))
    yp = tscan._pad_blocks(ys, (h, h) + (d,) * 4, (hp, hp) + (dp,) * 4)
    plan = tscan._f32_wgrad_plan(dp, hp, n_rows, route)
    emulate = emulate_narrow if route == "narrow" else emulate_wgmma
    part = emulate(z, xp, yp, dp, hp, plan)
    assert part.shape == (plan["splits"], tscan.partial_size(dp, hp))
    got = tscan._unpad_gtf(tscan.unpack_partial(part.sum(0), dp, hp), d, h)
    exp = tscan.gtf_wgrad_ref(z_traj, xs, ys)
    f64 = tscan.gtf_wgrad_ref(z_traj.double(), xs.double(), ys.double())
    for name in tscan.GTF_LAYERS:
        for kk in ("w", "b"):
            g, e = got[name][kk], exp[name][kk]
            assert g.shape == e.shape
            assert _max_norm_ok(g, e), (name, kk)
            assert _rfro(g, f64[name][kk]) < F64_RFRO, (
                name, kk, _rfro(g, f64[name][kk]), _rfro(e, f64[name][kk]))
