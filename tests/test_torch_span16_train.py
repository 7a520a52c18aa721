"""The bf16 training span kernel of B8 (`csrc/span16_train.cu`), on the
CPU: its launch plan (`span16_train_plan`) at every shape the smoke and
the card tests run, and the file's `span16_train_steps`, the kernel's
steps in torch: the ghost group's bands a CTA each (`span16_band`), the
halo rows traded between bands (`span16_halo`), the slot relabelling of
the channel shuffle (`span16_train_slots`), each BN's statistics and
backward sums as the CTAs' sums added in rank order (the mean, then
Σ(u-μ)²), the bf16 rounding points, the backward's f32 gradient in the
slots and dW1, dW2 from du's two bf16 terms.  On bf16 inputs the steps are
held to the plain versions `span_train_forward_reference` /
`span_train_backward_reference` within the card's bounds (out, saved
inputs, dx and each weight gradient within 2⁻⁶ of max |value|, the first
block's stats within 5e-5), and a wrong band, halo or slot table is
caught."""

import pytest
import torch

from fastdet_torch.kernels import fused_train as ft
from torch_cases import (BF16_TRAIN_RTOL, SPAN_TRAIN_B1, SPAN_TRAIN_CONV,
                         SPAN_TRAIN_EDGE, SPAN_TRAIN_FULL, SPAN_TRAIN_SMALL,
                         few_torch_threads, span16_backward_errs,
                         span_train_case)

BF16 = torch.bfloat16
STATS_RTOL = 5e-5
PLAN_CASES = SPAN_TRAIN_FULL + SPAN_TRAIN_B1 + SPAN_TRAIN_SMALL + \
    SPAN_TRAIN_EDGE + SPAN_TRAIN_CONV
# the small and edge shapes, and some cut into bands by a forced cluster,
# so that the halo rows cross CTAs (a band of 3 rows, one of 1 row, 2
# bands an image of 9 rows, one CTA an image at g = 2), and 7 blocks in
# bands (the slots and the rounded passthrough gradients of a stage-3
# span); last the convergence check's three stages, whose clusters hold
# whole images, 2 or 4 a CTA
STEP_CASES = ([(c, None) for c in SPAN_TRAIN_SMALL + SPAN_TRAIN_EDGE]
              + [((4, 48, 6, 7, 2, 2), 4), ((5, 48, 13, 5, 3, 1), 4),
                 ((3, 96, 9, 7, 2, 3), 6), ((4, 192, 3, 3, 3, 2), 2),
                 ((2, 96, 10, 6, 7, 2), 4)]
              + [(c, None) for c in SPAN_TRAIN_CONV])


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("case", PLAN_CASES, ids=[
    "x".join(map(str, c)) for c in PLAN_CASES])
def test_plan_fits_the_card(case):
    b, c, h, w, nblk, g = case
    plan = ft.span16_train_plan(b, c, h, w, nblk, g)
    mid = c // 2
    assert max(plan.smem_fwd, plan.smem_bwd) <= ft.SMEM_PER_CTA == 232448
    assert plan.smem_fwd == ft.span16_train_smem(mid, plan.rows, w, plan.ipc,
                                                 plan.cluster, False)
    assert plan.pixels == plan.ipc * plan.rows * w <= \
        ft.SPAN16_TRAIN_PMAX[mid]
    assert 1 <= plan.cluster <= ft.SPAN16_TRAIN_MAX_CLUSTER
    if plan.ipc > 1:
        assert plan.bpi == 1 and plan.rows == h
        assert plan.cluster * plan.ipc == g
    else:
        assert plan.cluster == g * plan.bpi
    assert plan.ctas == plan.part_rows == b // g * plan.cluster
    assert (plan.launches_fwd, plan.launches_bwd) == (1, 2)
    # the bands cover each image of each group once, no band empty
    bands = plan.band_rows(h)
    assert all(n >= 1 for _, n in bands) and sum(n for _, n in bands) == h
    for gi in {0, b // g - 1}:
        seen = []
        for rank in range(plan.cluster):
            bd = ft.span16_band(plan, g, h, w, gi, rank)
            assert bool(bd["live"].any())
            lv = bd["live"]
            seen += (bd["img"][lv] * h * w + bd["off"][lv]).tolist()
        assert sorted(seen) == list(range(gi * g * h * w,
                                          (gi + 1) * g * h * w))


def test_plan_at_352():
    """The b128 352² stages: clusters of 8 bands of 11×44 (4 an image) and
    of 11×22 (2 an image), and of 16 whole 11×11 images (past the portable
    8), one launch forward and two backward a stage call."""
    plans = [ft.span16_train_plan(*case) for case in SPAN_TRAIN_FULL]
    assert [p.args for p in plans] == [(8, 4, 1, 11), (8, 2, 1, 11),
                                       (16, 1, 1, 11)]
    assert [p.ctas for p in plans] == [512, 256, 128]
    assert [p.nonportable for p in plans] == [False, False, True]
    assert all((p.launches_fwd, p.launches_bwd) == (1, 2) for p in plans)


def test_plan_refuses_what_fits_no_cluster():
    with pytest.raises(ValueError, match="fits no cluster"):
        ft.span16_train_plan(2, 48, 160, 160, 3, 1)      # 25600 pixels
    with pytest.raises(ValueError, match="fits no cluster"):
        ft.span16_train_plan(4, 48, 6, 7, 2, 2, cluster=3)
    with pytest.raises(ValueError, match="no plan"):
        ft.span16_train_plan(4, 48, 6, 7, 2, 3)          # group ∤ batch


@pytest.mark.parametrize("c", (48, 96, 192))
def test_slots_relabel_the_shuffle(c):
    """Block k's logical channel l lies in slot P_k(l): writing z_r into
    slot P_k(2r + 1) and reading through P_{k+1} gives cat[x[0::2], z] for
    seven blocks."""
    mid = c // 2
    phys = list(range(c))                    # slot → value
    logical = list(range(c))                 # the shuffle done by copying
    nxt = c
    for k in range(7):
        cur = ft.span16_train_slots(k, c)
        assert [phys[cur[l]] for l in range(c)] == logical
        z = list(range(nxt, nxt + mid))
        nxt += mid
        for r in range(mid):
            phys[cur[2 * r + 1]] = z[r]
        logical = logical[0::2] + z
    assert sorted(ft.span16_train_slots(3, c)) == list(range(c))


def _check_steps(case, cluster, witness=False):
    """The steps against the plain versions → ({leaf: err}, the first
    block's worst stats err); `witness`: the backward's leaves over their
    `span16_backward_errs` witness bounds instead of BF16_TRAIN_RTOL."""
    b, c, h, w, nblk, g = case
    x, rows, dy = span_train_case(sum(case) + 1, b, c, h, w, nblk)
    x, dy = x.to(BF16), dy.to(BF16)
    plan = ft.span16_train_plan(b, c, h, w, nblk, g, cluster)
    out, xsave, stats, dx, drows = ft.span16_train_steps(x, rows, g, dy,
                                                         plan)
    ro, rxsave, rstats = ft.span_train_forward_reference(x, rows, g)
    errs = {"out": _rel(out, ro), "xsave": _rel(xsave, rxsave)}
    errs.update({f"stats{j}": _rel(stats[:, :, :, j], rstats[:, :, :, j])
                 for j in range(3)})
    held, _ = span16_backward_errs((dx, drows), dy, xsave, stats, rows, g,
                                   witness=witness)
    errs.update({k: e * BF16_TRAIN_RTOL / bound
                 for k, (e, bound) in held.items()})
    s0 = max(_rel(stats[0, :, :, j], rstats[0, :, :, j]) for j in range(3))
    return errs, s0


@pytest.mark.parametrize("case,cluster", STEP_CASES, ids=[
    "x".join(map(str, c)) + (f"-n{n}" if n else "") for c, n in STEP_CASES])
def test_steps_equal_the_plain_versions(case, cluster):
    with few_torch_threads():
        errs, s0 = _check_steps(case, cluster,
                                witness=case in SPAN_TRAIN_CONV)
    assert s0 <= STATS_RTOL
    off = {k: e for k, e in errs.items() if e > BF16_TRAIN_RTOL}
    assert not off, off


def test_steps_see_a_wrong_band_halo_or_slot(monkeypatch):
    """Each fault in the kernel's indexing shows beyond the bounds: a band
    that reads the row below its own, halo rows left at zero, and z_r
    stored in the slot of another channel."""
    case, n = (5, 48, 13, 5, 3, 1), 4
    good, _ = _check_steps(case, n)
    assert max(good.values()) <= BF16_TRAIN_RTOL
    band, h, w = ft.span16_band, case[2], case[3]

    def shifted(*args):
        bd = band(*args)
        bd["off"] = torch.clamp(bd["off"] + w, max=h * w - 1)
        return bd

    next_slots = ft.span16_next_slots

    def swapped(cur, mid):
        out = next_slots(cur, mid)
        out[mid], out[mid + 1] = out[mid + 1], out[mid]
        return out

    for name, fault in (("span16_band", shifted),
                        ("span16_halo", lambda *a: None),
                        ("span16_next_slots", swapped)):
        with monkeypatch.context() as m:
            m.setattr(ft, name, fault)
            errs, _ = _check_steps(case, n)
        assert max(errs.values()) > 4 * BF16_TRAIN_RTOL, (name, errs)


@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
def test_steps_record_the_du_their_leaves_come_from(acc):
    """`rec_du` (as the kernel's witness build, for `span16_witness.py`):
    each block's du3, du2, du1 recomputed in f64 from the steps' own
    inputs to it (`span16_witness.replay`) within a few units of 2⁻²⁴ of
    its error scale, far inside `LINK_TOL`, and each leaf recomputed from
    the recorded du within `REPRO_TOL` of the steps' own, on the kernel's
    saved inputs given as `saved`; in f64 the leaves that take du whole
    agree to 1e-12, and w1, w2, which take du's two bf16 terms, to 2⁻¹⁶."""
    import span16_witness as sw
    case = (4, 96, 5, 6, 2, 2)
    b, c, h, w, nblk, g = case
    x, rows, dy = span_train_case(sum(case), b, c, h, w, nblk)
    x, dy = x.to(BF16), dy.to(BF16)
    _, xsave, stats = ft.span_train_forward_reference(x, rows, g)
    du = torch.zeros((nblk, 3, b, c // 2, h, w), dtype=acc)
    with few_torch_threads():
        out = ft.span16_train_steps(x, rows, g, dy,
                                    ft.span16_train_plan(*case), acc,
                                    saved=(xsave, stats), rec_du=du)
        D, E, mine, _ = sw.replay(dy, xsave, stats, rows, g, rec=du,
                                  take=sw.every(nblk))
    assert bool((du != 0).any((2, 3, 4, 5)).all())      # all recorded
    assert float(sw.link_units(du, D, E).max()) <= 4.0
    errs = sw.leaf_shares(sw.leaves_of(out[4], c // 2), mine)
    for k, err in errs.items():
        whole = acc == torch.float64 and k.split(".")[1] not in ("w1", "w2")
        assert err <= (1e-12 if whole else 2.0 ** -16), (k, err)
        assert err <= sw.REPRO_TOL


@pytest.mark.parametrize("fault", ["span16_halo", "_rank_sum"])
def test_witness_steps_see_a_fault_in_du(monkeypatch, fault):
    """`span16_witness.py`'s step check sees a fault in the code that
    computes du: the steps with their halo rows left at zero, or with
    each cluster sum short of its last CTA's part (the BN backward's Σg,
    Σg·x̂ among them), stand more than `LINK_TOL` units from the same
    steps recomputed from their own recorded inputs; the faultless steps
    within 4 units."""
    import span16_witness as sw
    case, n = (5, 48, 13, 5, 3, 1), 4
    b, c, h, w, nblk, g = case
    x, rows, dy = span_train_case(sum(case), b, c, h, w, nblk)
    x, dy = x.to(BF16), dy.to(BF16)
    _, xsave, stats = ft.span_train_forward_reference(x, rows, g)
    plan = ft.span16_train_plan(b, c, h, w, nblk, g, n)
    rank_sum = ft._rank_sum
    faults = {"span16_halo": lambda *a: None,
              "_rank_sum": lambda parts: rank_sum(parts[:-1])}

    def worst():
        du = torch.zeros((nblk, 3, b, c // 2, h, w))
        ft.span16_train_steps(x, rows, g, dy, plan, saved=(xsave, stats),
                              rec_du=du)
        D, E, _, _ = sw.replay(dy, xsave, stats, rows, g, rec=du,
                               take=sw.every(nblk))
        return float(sw.link_units(du, D, E).max())

    with few_torch_threads():
        assert worst() <= 4.0
        monkeypatch.setattr(ft, fault, faults[fault])
        assert worst() > sw.LINK_TOL


def test_witness_reads_a_faultless_stand_in(monkeypatch, capsys):
    """`span16_witness.witness` end to end on the CPU, the f32 steps with
    their du recorded standing in for the kernel at a small case: every
    reading printed, and the step check reads "f32"."""
    import span16_witness as sw
    case = (8, 96, 4, 4, 3, 4)
    b, c, h, w, nblk, g = case
    monkeypatch.setattr(sw, "CASE", case)
    monkeypatch.setattr(sw, "ORDERS", 2)

    def steps(dy, xsave, stats, rows, g_):
        du = torch.zeros((nblk, 3, b, c // 2, h, w))
        out = ft.span16_train_steps(torch.zeros_like(dy), rows, g_, dy,
                                    ft.span16_train_plan(*case),
                                    saved=(xsave, stats), rec_du=du)
        return out[3], out[4], du

    x, rows, dy = span_train_case(sum(case), b, c, h, w, nblk)
    with few_torch_threads():
        verdict = sw.witness("stand-in", x.to(BF16), dy.to(BF16), rows, g,
                             kernel=steps)
    shown = capsys.readouterr().out
    for part in ("envelope:", "bf16 flips", "steps from own inputs",
                 "leaves from own du", "ladder"):
        assert part in shown, part
    assert verdict["steps"] == "f32"

