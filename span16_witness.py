#!/usr/bin/env python3
"""Why B8's bf16 backward stands past its witness bound at stage 4 with
trained weights: the kernel against the same function evaluated in f64 in
the kernel's own structure, and each step of the kernel against the same
step recomputed in f64 from the kernel's own inputs to it.

    python3 span16_witness.py [--rows ROWS.npz] [--save ROWS.npz]

On one NVIDIA card, from the repository root.  Without `--rows` it runs
the convergence check's bf16 fused s2d configuration at its defaults
(600 steps of b32 128², seed 0: what smoke phase 12 gates) and takes the
trained stage-4 span weights (`--save` writes them as `rows` in an .npz,
which `--rows` reads back).  Then, at (32, 192, 4, 4, 3, 16) on
`span_train_case`'s seeded x and dy, with the kernel's forward's saved
inputs and statistics, it computes the backward's leaves as

  (a) the kernel, `span_train_backward_bf16`;
  (b) the plain version `span_train_backward_reference`, f32 sums (card);
  (c) the same with every sum in f64 (its recompute too);
  (d) `span16_train_steps(acc=float64, saved=...)`: the kernel's bands,
      halo, slots, rounding points, du as its two bf16 terms in dW and
      the CTAs' partial rows reduced in the kernel's order, every
      backward product and sum in f64 (bf16 × bf16 products are exact
      there, so the tensor cores' k-order moves a sum by < 1e-13 of its
      terms), the recompute and its ReLU masks in f32 as the kernel's;
  (e) the same steps with f32 sums in torch's order;

and prints each leaf's distances as shares of the leaf's max |value|
(`torch_cases.span_train_rel_errs`), and the conditioning of each
block's dγ1: max over channels of Σ|g·x̂1| over the ghost group, over
max |dγ1| (from (c)).

Three readings follow.
- The envelope: (a) against (d) beside the f32 evaluations' own
  distances from (d), max(b-d, e-d) per leaf, and the largest over
  ORDERS more evaluations of (b) with the images of each ghost group
  permuted (the same function, its sums in other orders).  A leaf where
  a-d passes them reads "outside".
- The steps: the kernel records each block's f32 du3, du2 and du1, the
  values it rounds to bf16 (du3 before dv, du2 before the depthwise
  products) or splits into two bf16 terms (du1).  `replay` recomputes,
  in f64, du3 from the block's output gradient (the block above's
  recorded du1 through W1ᵀ, the passthrough rounded where read), du2
  from bf16(du3) and du1 from bf16(du2), each BN backward with the
  kernel's masks, and each leaf from the recorded du.  A step of the
  kernel that stands from its recomputation by more than LINK_TOL units
  of 2⁻²⁴ of the step's error scale, or a leaf by more than REPRO_TOL of
  its max |value|, is a fault in the kernel's arithmetic; (e) and (d)
  run through the same check.
- The ladder: the leaves recomputed in f64 taking the kernel's rounding
  of du3, then of du2, then its du1, against (d): at which rounding
  point the kernel's distance from (d) comes in.

The seeded weights of the card tests run beside the trained ones as the
control.
"""

import argparse
import os
import sys

CASE = (32, 192, 4, 4, 3, 16)
# a leaf recomputed in f64 from the kernel's own du may stand this far
# (share of its max |value|) from the kernel's: f32 sums of at most 512
# products; the distance in question, C3's, is 5e-2
REPRO_TOL = 1e-3
# a step recomputed in f64 from an evaluation's own inputs may stand this
# far from its f32 du, in units of 2^-24 of the step's error scale (the
# sum of |terms| of its sums, `_bn_back64`): a correct f32 step sums at
# most m + C/2 = 352 terms a value, so it rounds by at most that many
# units in any order (twice that toward zero); the faults of
# tests/test_torch_span16_train.py stand 1e5 or more off
LINK_TOL = 1024.0
U = 2.0 ** -24
# f32 evaluations of the plain version in other sum orders (the envelope)
ORDERS = 16
STAGE4 = ("stage4_1", "stage4_2", "stage4_3")
STEPS = ("du3", "du2", "du1")


def trained_rows(save: str):
    """The bf16 fused s2d convergence run at its defaults (seed 0) → its
    stage-4 span weights, packed."""
    import numpy as np
    import torch
    from fastdet_torch.kernels import fused_train as ft
    from fastdet_torch.tools import convergence_check as cc
    rec = {}
    aps = cc.run_convergence(device="cuda", record=rec, bf16=True,
                             fused_backbone=True, input_format="s2d_u8")
    print(f"convergence run: AP curve {[round(a, 4) for a in aps]}, "
          f"{'OK' if cc.converged(aps) else 'FAILED'}", flush=True)
    bb = rec["trainer"].model.backbone
    rows = ft.pack_span_train_weights([getattr(bb, n) for n in STAGE4])
    rows = rows.detach().float().contiguous()
    if save:
        os.makedirs(os.path.dirname(os.path.abspath(save)), exist_ok=True)
        np.savez(save, rows=rows.cpu().numpy())
        print(f"saved {save}", flush=True)
    return rows


def bn1_conditioning(dy, xsave, stats, rows, g):
    """(nblk,) max over channels of Σ|g·x̂| / max |dγ1| of each block's BN1,
    from the plain version in f64."""
    import torch
    from fastdet_torch.kernels import fused_train as ft
    seen = []
    inner = ft._bn_backward

    def spy(gr, xhat, gamma, sinv, g_):
        b, mid = gr.shape[:2]
        seen.append((gr * xhat).abs().reshape(b // g_, g_, mid, -1)
                    .sum((1, 3)).sum(0))
        return inner(gr, xhat, gamma, sinv, g_)

    ft._bn_backward = spy
    try:
        _, drows = ft.span_train_backward_reference(
            dy, xsave, stats, rows, g, torch.float64)
    finally:
        ft._bn_backward = inner
    mid = dy.shape[1] // 2
    g1 = [s for n, s, e in ft.row_sections(mid) if n == "g1"][0]
    nblk = rows.shape[0]
    out = []
    for i in range(nblk):
        terms = seen[3 * (nblk - 1 - i) + 2]     # blocks last first, BN1 last
        dg1 = drows[i, g1:g1 + mid].abs().max()
        out.append(float(terms.max() / dg1))
    return out


def kernel_with_du(dy, xsave, stats, rows, g):
    """The kernel's backward (`span16_backward_launch`, the launches of the
    counted `span_train_backward_bf16`) with each block's du3, du2, du1
    recorded → (dx, drows, du (nblk, 3, B, C/2, h, w) f32)."""
    import torch
    from fastdet_torch.kernels import fused_train as ft
    b, c, h, w = dy.shape
    du = torch.zeros((rows.shape[0], 3, b, c // 2, h, w), device=dy.device)
    dx, drows = ft.span16_backward_launch(dy, xsave, stats, rows, g,
                                          rec_du=du)
    return dx, drows, du


def _bn_back64(gr, gabs, u, st, gamma, g):
    """BN's backward in f64 of the masked gradient gr (B, mid, h, w) under
    the saved (μ, σinv) st, x̂ = (u - μ)·σinv in f32 from the f32
    recompute u, as the kernel's → (du, its error scale, dγ, dβ).  The
    scale is Σ|terms| of du's sums: |gr| and its own (gabs, the |terms|
    of the sum that made gr), and through the group sums Σg and Σg·x̂."""
    from fastdet_torch.kernels import fused_train as ft
    b, mid, h, w = gr.shape
    m = g * h * w
    xh = ft._xhat(u, st, g).double()

    def grp(t):
        return ft._per_image(t.reshape(b // g, g, mid, -1).sum((1, 3)), g)

    kk = ft._per_image(gamma.double() * st[1].double(), g)
    du = kk * (gr - grp(gr) / m - xh * grp(gr * xh) / m)
    a = gr.abs() + gabs
    err = kk.abs() * (a + grp(a) / m + xh.abs() * grp(a * xh.abs()) / m)
    err = err + du.abs()
    return du, err, (gr * xh).sum((0, 2, 3)), gr.sum((0, 2, 3))


def _bf16_beside(r0, t):
    """The bf16 value next to r0 (bf16 values held in f64) on t's side."""
    import torch
    bits = r0.float().view(torch.int32)
    step = torch.where((t > r0) == (r0 > 0), 65536, -65536).to(torch.int32)
    return (bits + step).view(torch.float32).double()


def every(nblk):
    """`replay`'s `take` of every block's du3, du2 and du1."""
    return {(k, s) for k in range(nblk) for s in STEPS}


def replay(dy, xsave, stats, rows, g, rec=None, take=()):
    """The bf16 backward in f64 at the kernel's rounding points, the
    recompute and its ReLU masks in f32 as the kernel's; for each (block,
    step) in `take` (steps "du3", "du2", "du1") the recorded du of `rec`
    (nblk, 3, B, C/2, h, w) goes on in place of the replay's own:
    bf16(du3) into dv and du3 into dW2, bf16(du2) into dwd and the
    depthwise, du1 into dW1 and bf16(du1) into the block's input
    gradient.  A passthrough value is rounded where a block reads it as
    dz; where its f64 value lies so near a bf16 midpoint that f32
    rounding could take it to either side, the side is read off rec's
    du3 (the block above's du1 taken).  → (D: each step's
    du from its inputs, E: their error scales, both (nblk, 3, B, C/2, h,
    w) f64; the leaves {blk{k}.{w1, wd, w2, g1, b1, g2, b2, g3, b3}};
    the count of such near-midpoint values)."""
    import torch
    import torch.nn.functional as F
    from fastdet_torch.kernels import fused_train as ft
    from fastdet_torch.models.layers import round16
    b, c, h, w = dy.shape
    mid, nblk = c // 2, rows.shape[0]
    D = torch.zeros((nblk, 3, b, mid, h, w), dtype=torch.float64)
    E = torch.zeros_like(D)
    leaves, near_mid = {}, 0

    def r16(t):
        return round16(t.float()).double()

    def taken(k, j, own):
        return rec[k, j].double().cpu() if (k, STEPS[j]) in take else own

    cur, cabs = dy.double().cpu(), torch.zeros(dy.shape, dtype=torch.float64)
    for k in range(nblk - 1, -1, -1):
        row = rows[k].float().cpu()
        st = stats[k].float().cpu().transpose(1, 2)
        x = xsave[k].float().cpu()
        u1, y, u2, v, u3, _ = ft._block_forward(x, row, st, g, round16)
        w1, wd, w2, gbf = ft._unpack(row, mid)
        w1, wd, w2 = (round16(t).double() for t in (w1, wd, w2))
        gb = gbf.double()
        # dz: the block output's z half, an even channel rounded where read
        t, tabs = cur[:, mid::2], cabs[:, mid::2]
        r0 = r16(t)
        dz, dzabs = cur[:, mid:].clone(), cabs[:, mid:].clone()
        dz[:, 0::2], dzabs[:, 0::2] = r0, 0.0
        mask3 = ft._bn(u3, st[2], gbf[4], gbf[5], g) > 0

        def step3(dz_):
            return _bn_back64(torch.where(mask3, dz_, 0.0),
                              torch.where(mask3, dzabs, 0.0), u3, st[2],
                              gb[4], g)

        out3 = step3(dz)
        if rec is not None and (k + 1, "du1") in take:
            r1 = _bf16_beside(r0, t)
            near = ((t != r0) & (r0 != 0)
                    & ((t - (r0 + r1) / 2).abs() <= 4 * mid * U * tabs))
            if bool(near.any()):
                near_mid += int(near.sum())
                alt = dz.clone()
                alt[:, 0::2] = torch.where(near, r1, r0)
                k3 = rec[k, 0].double().cpu()[:, 0::2]
                pick = near & ((k3 - step3(alt)[0][:, 0::2]).abs()
                               < (k3 - out3[0][:, 0::2]).abs())
                dz[:, 0::2] = torch.where(pick, r1, r0)
                out3 = step3(dz)
        du3, E[k, 0], dg3, db3 = out3
        D[k, 0] = du3
        d3 = taken(k, 0, du3)
        h3 = r16(d3)
        dv = torch.einsum("bohw,io->bihw", h3, w2)
        dvabs = torch.einsum("bohw,io->bihw", h3.abs(), w2.abs())
        du2, E[k, 1], dg2, db2 = _bn_back64(dv, dvabs, u2, st[1], gb[2], g)
        D[k, 1] = du2
        d2 = r16(taken(k, 1, du2))
        yp = F.pad(y.double(), (1, 1, 1, 1))
        dwd = torch.stack([(d2 * yp[:, :, q // 3:q // 3 + h,
                                    q % 3:q % 3 + w]).sum((0, 2, 3))
                           for q in range(9)])
        mask1 = ft._bn(u1, st[0], gbf[0], gbf[1], g) > 0
        gy = torch.where(mask1, ft._dw(d2, wd, flip=True), 0.0)
        gyabs = torch.where(mask1, ft._dw(d2.abs(), wd.abs(), flip=True),
                            0.0)
        du1, E[k, 2], dg1, db1 = _bn_back64(gy, gyabs, u1, st[0], gb[0], g)
        D[k, 2] = du1
        d1 = taken(k, 2, du1)
        h1 = r16(d1)
        dxo = torch.einsum("bohw,io->bihw", h1, w1)
        dxabs = torch.einsum("bohw,io->bihw", h1.abs(), w1.abs())
        cur = torch.stack([cur[:, :mid], dxo], 2).reshape(b, c, h, w)
        cabs = torch.stack([cabs[:, :mid], dxabs], 2).reshape(b, c, h, w)
        leaves.update({
            f"blk{k}.w1": torch.einsum("bihw,bohw->io",
                                       x[:, 1::2].double(), d1),
            f"blk{k}.wd": dwd,
            f"blk{k}.w2": torch.einsum("bihw,bohw->io", v.double(), d3),
            f"blk{k}.g1": dg1, f"blk{k}.b1": db1, f"blk{k}.g2": dg2,
            f"blk{k}.b2": db2, f"blk{k}.g3": dg3, f"blk{k}.b3": db3})
    return D, E, leaves, near_mid


def link_units(rec, D, E):
    """(nblk, 3) the largest |rec - D| of each block's du3, du2, du1 in
    units of 2⁻²⁴ of its error scale E."""
    r = (rec.double().cpu() - D).abs() / (U * E).clamp_min(1e-300)
    return r.amax((2, 3, 4, 5))


def leaves_of(drows, mid):
    """{leaf: values} of packed row gradients, as `replay` names them."""
    from fastdet_torch.kernels import fused_train as ft
    secs = {n: (lo, hi) for n, lo, hi in ft.row_sections(mid)}
    shape = {"w1": (mid, mid), "wd": (9, mid), "w2": (mid, mid)}
    return {f"blk{k}.{n}": drows[k, lo:hi].double().cpu()
            .reshape(shape.get(n, (mid,)))
            for k in range(drows.shape[0]) for n, (lo, hi) in secs.items()}


def leaf_shares(got, want):
    """{leaf: max |got - want| / scale} of two leaf dicts, the scale the
    leaf's max |want|, for β2 (0 in exact arithmetic) its block's largest
    BN-parameter gradient, as `torch_cases.span_train_rel_errs`."""
    out = {}
    for leaf, ref in want.items():
        blk, name = leaf.split(".")
        scale = float(ref.abs().max())
        if name == "b2":
            scale = max(float(want[f"{blk}.{n}"].abs().max())
                        for n in ("g1", "b1", "g2", "b2", "g3", "b3"))
        out[leaf] = float((got[leaf] - ref).abs().max()) / max(scale, 1e-30)
    return out


def other_orders(dy, xsave, stats, rows, g, n, seed=0):
    """The plain version with f32 sums, each time with the images of every
    ghost group in another seeded order (the same function, its group and
    batch sums added in other orders) → n (dx, drows), dx in the given
    order."""
    import torch
    from fastdet_torch.kernels import fused_train as ft
    gen = torch.Generator().manual_seed(seed)
    b = dy.shape[0]
    out = []
    for _ in range(n):
        perm = torch.cat([gi * g + torch.randperm(g, generator=gen)
                          for gi in range(b // g)]).to(dy.device)
        dx, drows = ft.span_train_backward_reference(
            dy[perm], xsave[:, perm], stats, rows, g)
        out.append((dx[torch.argsort(perm)], drows))
    return out


def witness(name, x, dy, rows, g, kernel=kernel_with_du):
    """Print (a)-(e)'s distances at CASE, the envelope, the steps and the
    ladder → {"envelope", "orders": "within" | "outside", "steps": "f32" |
    "fault"}: "outside" where a-d passes max(b-d, e-d) on some leaf
    (envelope), or every f32 evaluation's distance from (d), ORDERS
    other orders of (b) included (orders); "fault" where a step or a leaf
    of the kernel stands from its recomputation from the kernel's own
    inputs by more than LINK_TOL / REPRO_TOL.  `kernel`: (dy, xsave,
    stats, rows, g) → (dx, drows, du) as `kernel_with_du`."""
    import torch
    from fastdet_torch.kernels import fused_train as ft
    from fastdet_torch.models.layers import round16
    from torch_cases import span_train_rel_errs
    b, c, h, w, nblk, _ = CASE
    mid = c // 2
    _, xsave, stats = ft.span_train_forward_bf16(x, rows, g)
    counted = ft.span_train_backward_bf16(dy, xsave, stats, rows, g)
    a_dx, a_rows, du_a = kernel(dy, xsave, stats, rows, g)
    same = bool(torch.equal(a_dx, counted[0])
                and torch.equal(a_rows, counted[1]))
    a = (a_dx, a_rows)
    p32 = ft.span_train_backward_reference(dy, xsave, stats, rows, g)
    p64 = ft.span_train_backward_reference(dy, xsave, stats, rows, g,
                                           torch.float64)
    more = other_orders(dy, xsave, stats, rows, g, ORDERS)
    if x.is_cuda:
        torch.cuda.synchronize()
    cpu = [t.cpu() for t in (x, rows, dy, xsave, stats)]
    plan = ft.span16_train_plan(*CASE)
    du_d = torch.zeros((nblk, 3, b, mid, h, w), dtype=torch.float64)
    du_e = torch.zeros((nblk, 3, b, mid, h, w))
    s64 = ft.span16_train_steps(cpu[0], cpu[1], g, cpu[2], plan,
                                torch.float64, saved=tuple(cpu[3:]),
                                rec_du=du_d)[3:]
    s32 = ft.span16_train_steps(cpu[0], cpu[1], g, cpu[2], plan,
                                saved=tuple(cpu[3:]), rec_du=du_e)[3:]
    kappa = bn1_conditioning(dy, xsave, stats, rows, g)
    a, p32, p64 = [tuple(t.cpu() for t in r) for r in (a, p32, p64)]
    more = [tuple(t.cpu() for t in r) for r in more]
    pairs = {"a-b": (a, p32), "b-c": (p32, p64), "a-c": (a, p64),
             "a-d": (a, s64), "e-d": (s32, s64), "b-d": (p32, s64),
             "d-c": (s64, p64)}
    errs = {k: span_train_rel_errs(*u, *v) for k, (u, v) in pairs.items()}
    od = [span_train_rel_errs(*r, *s64) for r in more]
    errs["orders-d"] = {leaf: max(e[leaf] for e in od) for leaf in od[0]}
    print(f"{name}: plan {plan.args}, the recording launch bitwise the "
          f"main build's counted one: {same}; dγ1 conditioning (max_ch Σ|g·x̂1| / "
          f"max|dγ1|) by block {[round(k, 2) for k in kappa]}", flush=True)
    print("  leaf       " + "".join(f"{k:>10}" for k in errs) +
          "  witness bound 2·(b-c)", flush=True)
    for leaf in errs["a-b"]:
        print(f"  {leaf:10} " + "".join(f"{errs[k][leaf]:10.4%}"
                                        for k in errs)
              + f"  {max(2 ** -6, 2 * errs['b-c'][leaf]):.4%}", flush=True)
    # the envelope: a-d beside every f32 evaluation's distance from (d)
    env = {leaf: max(errs["b-d"][leaf], errs["e-d"][leaf],
                     errs["orders-d"][leaf]) for leaf in errs["a-d"]}
    ratio = {leaf: errs["a-d"][leaf] / max(env[leaf], 1e-12)
             for leaf in env}
    worst = max(ratio, key=ratio.get)
    outside = [leaf for leaf in env if errs["a-d"][leaf] > env[leaf]]
    two = {leaf: max(errs["b-d"][leaf], errs["e-d"][leaf]) for leaf in env}
    first = max(env, key=lambda leaf: errs["a-d"][leaf] / max(two[leaf],
                                                              1e-12))
    print(f"  envelope: worst leaf against (d) by max(b-d, e-d): {first}: "
          f"a-d {errs['a-d'][first]:.4%}, max(b-d, e-d) {two[first]:.4%}"
          f"; with {len(more)} other orders of (b): {worst}: a-d "
          f"{errs['a-d'][worst]:.4%}, envelope {env[worst]:.4%} "
          f"({ratio[worst]:.2f}x); outside on {len(outside)} leaves "
          f"{outside}", flush=True)
    # the rounding points: how many of du3, du2, du1 round to another
    # bf16 value than (d)'s
    du_a = du_a.cpu()
    for k in range(nblk - 1, -1, -1):
        ref = round16(du_d[k])
        n = [[int((round16(t[k, j].double()) != ref[j]).sum())
              for t in (du_a, du_e)] for j in range(3)]
        print(f"  blk{k} bf16 flips against (d) of {du_d[k, 0].numel()}: "
              + "; ".join(f"{nm} kernel {fk} / steps-f32 {fe}"
                          for nm, (fk, fe) in zip(STEPS, n)), flush=True)
    # the steps: each evaluation's du and leaves against the same
    # recomputed in f64 from its own inputs
    saved = (cpu[2], cpu[3], cpu[4], cpu[1], g)     # dy, xsave, stats, rows
    runs = {"kernel": (du_a, leaves_of(a[1], mid)),
            "steps-f32": (du_e, leaves_of(s32[1], mid)),
            "steps-f64": (du_d, leaves_of(s64[1], mid))}
    units, repro, near = {}, {}, {}
    for who, (du, lv) in runs.items():
        D, E, mine, near[who] = replay(*saved, rec=du, take=every(nblk))
        units[who] = link_units(du, D, E)
        repro[who] = leaf_shares(lv, mine)
    print("  steps from own inputs, units of 2^-24 of the step's error "
          f"scale (fault above {LINK_TOL:g}):", flush=True)
    print("  step     " + "".join(f"{who:>12}" for who in runs), flush=True)
    for k in range(nblk - 1, -1, -1):
        for j, nm in enumerate(STEPS):
            print(f"  blk{k}.{nm} " + "".join(
                f"{float(units[who][k, j]):12.3f}" for who in runs),
                flush=True)
    print("  leaves from own du, share of max |value| (fault above "
          f"{REPRO_TOL:g}): " + ", ".join(
              f"{who} worst {max(r.values()):.3e}"
              for who, r in repro.items())
          + f"; near-midpoint passthrough values {near}", flush=True)
    # the ladder: each block's leaves from (d), the kernel's du taken at
    # the blocks above, then its du3, du2, du1 at the block
    d_leaves = leaves_of(s64[1], mid)
    kfar = leaf_shares(runs["kernel"][1], d_leaves)
    names = ("w1", "wd", "w2", "g1", "b1")
    print("  ladder, share of max |value| from (d), the kernel's du taken:",
          flush=True)
    for k in range(nblk - 1, -1, -1):
        print(f"    blk{k}              " + "".join(f"{n:>10}"
                                                for n in names), flush=True)
        above = {(i, s) for i in range(k + 1, nblk) for s in STEPS}
        for j in range(4):
            _, _, mine, _ = replay(*saved, rec=du_a, take=above | {
                (k, s) for s in STEPS[:j]})
            far = leaf_shares(mine, d_leaves)
            label = "".join("+" + s for s in STEPS[:j])
            label = ("above" if above else "none") + label
            print(f"    {label:18}" + "".join(f"{far[f'blk{k}.{n}']:10.4%}"
                                          for n in names), flush=True)
        print(f"    {'(a)':18}" + "".join(f"{kfar[f'blk{k}.{n}']:10.4%}"
                                      for n in names), flush=True)
    fault = (float(units["kernel"].max()) > LINK_TOL
             or max(repro["kernel"].values()) > REPRO_TOL)
    verdict = {"envelope": "outside" if errs["a-d"][first] > two[first]
               else "within",
               "orders": "outside" if outside else "within",
               "steps": "fault" if fault else "f32"}
    print(f"  verdict {verdict}", flush=True)
    return verdict


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="",
                    help="trained stage-4 rows (.npz) instead of the run")
    ap.add_argument("--save", default="",
                    help="write the trained stage-4 rows to this .npz")
    args = ap.parse_args()
    import subprocess
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("span16_witness: no CUDA card", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    for path in (repo, os.path.join(repo, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    from fastdet_torch import disable_tf32
    from torch_cases import span_train_case
    disable_tf32(torch.device("cuda"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if args.rows:
        rows = torch.from_numpy(np.load(args.rows)["rows"]).cuda()
    else:
        rows = trained_rows(args.save).cuda()
    b, c, h, w, nblk, g = CASE
    x32, seeded, dy32 = span_train_case(sum(CASE) + 1, b, c, h, w, nblk,
                                        "cuda")
    x, dy = x32.to(torch.bfloat16), dy32.to(torch.bfloat16)
    verdicts = [witness("seeded weights (control)", x, dy, seeded, g),
                witness("trained weights (C3)", x, dy, rows.contiguous(), g)]
    print(f"verdicts {verdicts} on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
