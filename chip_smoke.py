#!/usr/bin/env python3
"""Run the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases, one printed line (or more) each:

1. device — the card's name and power limit (``nvidia-smi``);
2. build  — ``nvcc`` builds every kernel of the serving path from
   ``src/repro_torch/csrc`` (one process per source, all at once);
3. kernels — each kernel at the serving path's shapes and at a small case
   with window, softcap, ragged lengths and -1 page-table entries, held
   against its plain PyTorch version on the card; kernel, plain and library
   times from CUDA events;
4. check  — prefill-then-paged-decode logits against one full-sequence
   prefill of the same tokens;
5. serve  — grok-1-314b at its published widths (depth cut to 4 of 64
   layers), random weights from ``--seed``, serves 8 chat requests
   through ``ServeEngine`` twice: reconfiguration off, then on
   (the on-run permutes the expert weights in place).  Tokens must be
   bit-identical, the control plane must reconfigure, and every kernel's
   launch count must grow during the serve;
6. the kernels line (JSON), the card line, and the result line
   ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, without a CUDA card or outside a
checkout of the repository.  Every failure propagates.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
SRC = REPO / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, no sparsity
BF16_TOL = dict(rtol=1.6e-2, atol=1e-5)  # torch.testing bf16 defaults
F32_TOL = dict(rtol=1.3e-6, atol=1e-5)  # torch.testing f32 defaults
LAYERS = 4  # of grok-1's 64: 42.6 GB of weights on an 80 GB card
REQUESTS = 8

KERNEL_ROWS = {
    "topk_gating": ("src/repro_torch/csrc/topk_gating.cu", "src/repro/kernels/topk_gating.py:44"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:105"),
    "paged_flash_decode": ("src/repro_torch/csrc/paged_flash_decode.cu",
                           "src/repro/kernels/flash_attention.py:226"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound(bytes_moved: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(torch, got, want, tol, what: str) -> float:
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **tol, msg=lambda m: f"{what}: {m}")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------


def page_table_for(torch, lengths, c: int, page: int, max_pages: int, num_pages: int, gen):
    """A permuted page table covering positions < t + C of each row, -1 past it."""
    b = len(lengths)
    perm = torch.randperm(num_pages, generator=gen)[: b * max_pages].reshape(b, max_pages)
    used = torch.tensor([-(-(t + c) // page) for t in lengths])
    table = torch.where(torch.arange(max_pages)[None, :] < used[:, None], perm, -1)
    return table.to(torch.int32)


def kernel_phase(torch, cfg, prompt_lens, slots: int, page: int, max_len: int, seed: int):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda, paged_flash_decode_cuda
    from repro_torch.kernels.topk_gating import topk_gating_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    cpu_g = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rows = {}

    # -- topk_gating at a decode tick's shape: [live slots, E] f32, k = top_k.
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    logits = torch.randn((slots, e), generator=g, device=dev)
    w, i = topk_gating_cuda(logits, k)
    rw, ri = ref.topk_gating(logits, k)
    assert torch.equal(i, ri), "topk_gating ids differ from the plain version"
    err = check(torch, w, rw, F32_TOL, "topk_gating")
    ms = time_ms(torch, lambda: topk_gating_cuda(logits, k), 200)
    plain = time_ms(torch, lambda: ref.topk_gating(logits, k), 200)
    lib = time_ms(torch, lambda: torch.topk(torch.softmax(logits, -1), k, dim=-1), 200)
    bms, by = bound(slots * e * 4 + slots * k * 8, slots * e * (5 + k), "float32")
    rows["topk_gating"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                               bound_by=by, library_ms=lib, shape=f"logits [{slots}, {e}] f32, k={k}")

    # -- flash_attention at the longest prompt's prefill: q [1, Hq, S, D] bf16.
    s = max(prompt_lens)
    q = torch.randn((1, hq, s, d), generator=g, device=dev).to(bf16)
    kk = torch.randn((1, hkv, s, d), generator=g, device=dev).to(bf16)
    vv = torch.randn((1, hkv, s, d), generator=g, device=dev).to(bf16)
    out = flash_attention_cuda(q, kk, vv, causal=True)
    err = check(torch, out, ref.flash_attention(q, kk, vv, causal=True), BF16_TOL, "flash_attention")
    kx = kk.repeat_interleave(hq // hkv, dim=1)
    vx = vv.repeat_interleave(hq // hkv, dim=1)
    ms = time_ms(torch, lambda: flash_attention_cuda(q, kk, vv, causal=True), 50)
    plain = time_ms(torch, lambda: ref.flash_attention(q, kk, vv, causal=True), 20)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True), 50)
    pairs = s * (s + 1) / 2
    bms, by = bound(2 * (2 * hq + 2 * hkv) * s * d, 4 * hq * d * pairs, "bfloat16")
    rows["flash_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                                   bound_by=by, library_ms=lib,
                                   shape=f"q [1, {hq}, {s}, {d}] bf16 causal")

    # -- paged_flash_decode at a decode tick: q [slots, 1, Hq, D] over the pool.
    max_pages = -(-max_len // page)
    num_pages = slots * max_pages
    lengths = [min(n, max_len - 1) for n in prompt_lens[:slots]]
    table = page_table_for(torch, lengths, 1, page, max_pages, num_pages, cpu_g).to(dev)
    tvec = torch.tensor(lengths, dtype=torch.int32, device=dev)
    qd = torch.randn((slots, 1, hq, d), generator=g, device=dev).to(bf16)
    kp = torch.randn((num_pages, page, hkv, d), generator=g, device=dev).to(bf16)
    vp = torch.randn((num_pages, page, hkv, d), generator=g, device=dev).to(bf16)
    out = paged_flash_decode_cuda(qd, kp, vp, table, tvec)
    err = check(torch, out, ref.paged_flash_decode(qd, kp, vp, table, tvec), BF16_TOL,
                "paged_flash_decode")
    ms = time_ms(torch, lambda: paged_flash_decode_cuda(qd, kp, vp, table, tvec), 200)
    plain = time_ms(torch, lambda: ref.paged_flash_decode(qd, kp, vp, table, tvec), 20)
    pos = torch.arange(max_pages * page, device=dev)
    mask = pos[None, None, None, :] <= tvec[:, None, None, None]  # [B, 1, 1, L]

    def sdpa_paged():
        vk = ref.paged_gather_kv(kp, table).transpose(1, 2).repeat_interleave(hq // hkv, 1)
        vv_ = ref.paged_gather_kv(vp, table).transpose(1, 2).repeat_interleave(hq // hkv, 1)
        return F.scaled_dot_product_attention(qd.transpose(1, 2), vk, vv_, attn_mask=mask)

    lib = time_ms(torch, sdpa_paged, 100)
    kv_bytes = sum((t + 1) * hkv * d * 2 * 2 for t in lengths)
    flops = sum(4 * hq * d * (t + 1) for t in lengths)
    bms, by = bound(2 * slots * hq * d * 2 + kv_bytes + table.numel() * 4 + slots * 4, flops,
                    "bfloat16")
    rows["paged_flash_decode"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        shape=f"q [{slots}, 1, {hq}, {d}] bf16, pool [{num_pages}, {page}, {hkv}, {d}], "
              f"t={lengths}",
    )
    for name, r in rows.items():
        print(f"kernel {name} ({r['shape']}): max_abs_err={r['max_abs_err']:.3e} "
              f"kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']:.5f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']})",
              flush=True)
    edge_cases(torch, g, cpu_g)
    return rows


def edge_cases(torch, g, cpu_g):
    """Window, softcap, ragged S, -1 table entries and C > 1, in f32 and bf16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda, paged_flash_decode_cuda
    from repro_torch.kernels.topk_gating import topk_gating_cuda

    dev = torch.device("cuda")
    logits = torch.randn((45, 160), generator=g, device=dev)
    logits[0] = 0.5  # an all-tied row: ids must be 0..k-1
    w, i = topk_gating_cuda(logits, 6)
    rw, ri = ref.topk_gating(logits, 6)
    assert torch.equal(i, ri) and i[0].tolist() == list(range(6)), "topk tie order"
    errs = [check(torch, w, rw, F32_TOL, "topk_gating edge")]
    for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for d in (64, 128, 256):
            q = torch.randn((2, 6, 77, d), generator=g, device=dev).to(dt)
            k = torch.randn((2, 2, 77, d), generator=g, device=dev).to(dt)
            v = torch.randn((2, 2, 77, d), generator=g, device=dev).to(dt)
            for kw in (dict(causal=True, window=33, softcap=30.0), dict(causal=False)):
                got = flash_attention_cuda(q, k, v, **kw)
                errs.append(check(torch, got, ref.flash_attention(q, k, v, **kw), tol,
                                  f"flash_attention edge {dt} D={d} {kw}"))
        for c in (1, 2, 5):
            lengths = [37, 20, 3]
            table = page_table_for(torch, lengths, c, 8, 7, 30, cpu_g).to(dev)
            tvec = torch.tensor(lengths, dtype=torch.int32, device=dev)
            qd = torch.randn((3, c, 6, 128), generator=g, device=dev).to(dt)
            kp = torch.randn((30, 8, 2, 128), generator=g, device=dev).to(dt)
            vp = torch.randn((30, 8, 2, 128), generator=g, device=dev).to(dt)
            for kw in ({}, dict(window=12, softcap=25.0)):
                got = paged_flash_decode_cuda(qd, kp, vp, table, tvec, **kw)
                errs.append(check(torch, got, ref.paged_flash_decode(qd, kp, vp, table, tvec, **kw),
                                  tol, f"paged_flash_decode edge {dt} C={c} {kw}"))
    torch.cuda.synchronize()
    print(f"kernels edge cases: {len(errs)} comparisons within tolerance, "
          f"max_abs_err={max(errs):.3e}", flush=True)


# ---------------------------------------------------------------------------
# phase 4: decode through the paged cache vs one full prefill
# ---------------------------------------------------------------------------


def decode_vs_prefill(torch, params, cfg, plan, tokens, page: int, device="cuda") -> float:
    """Prefill ``tokens[:m]`` into pages, continue ``tokens[m:]`` as a paged
    decode-mode chunk (the flash-decode kernel), and hold the last
    position's logits against one full prefill of all of ``tokens`` (the
    flash kernel).  Tolerance: 5e-2 of the logits' largest magnitude, for
    bf16 activations rounded along two different paths through 4 layers."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.batching import _scatter_prompt_pages

    dev = torch.device(device)
    n = len(tokens)
    m = n // 2
    pages = -(-n // page)
    caches = tfm.init_paged_caches(cfg, pages + 1, page, device=dev)
    table = torch.arange(1, pages + 1, dtype=torch.int32)[None, :]  # page 0 stays unused
    with torch.no_grad():
        _, _, one = tfm.model_apply(
            params, {"tokens": torch.tensor(tokens[None, :m], device=dev)}, cfg, plan,
            mode="prefill",
        )
        _scatter_prompt_pages(caches, tfm.pad_caches(one, pages * page), table[0].numpy())
        feats, _, _ = tfm.model_apply(
            params, {"tokens": torch.tensor(tokens[None, m:], device=dev)}, cfg, plan,
            mode="decode", caches=caches, t=torch.tensor([m], dtype=torch.int32, device=dev),
            page_table=table.to(dev),
        )
        paged = tfm.logits_from_features(params, feats[:, -1:], cfg).float()
        feats, _, _ = tfm.model_apply(
            params, {"tokens": torch.tensor(tokens[None, :], device=dev)}, cfg, plan,
            mode="prefill",
        )
        full = tfm.logits_from_features(params, feats[:, -1:], cfg).float()
    assert torch.isfinite(paged).all() and torch.isfinite(full).all(), "non-finite logits"
    scale = full.abs().max().item()
    err = (paged - full).abs().max().item()
    assert err <= 5e-2 * scale, f"paged decode logits differ from prefill: {err} vs scale {scale}"
    return err / scale


# ---------------------------------------------------------------------------
# phase 5: serve
# ---------------------------------------------------------------------------


def serve(torch, params, cfg, plan, reqs, gen, *, reconfig_every: int, slots: int,
          max_len: int, page: int, device="cuda"):
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    scfg = ServeConfig(slots=slots, max_len=max_len, page_size=page,
                       reconfig_every=reconfig_every, reconfig_min_gain=0.0, num_devices=4)
    eng = ServeEngine(params, cfg, plan, scfg, device=device)
    # Host clock per tick: every tick ends in a host read of its tokens.
    tick_ms, tick_step = [], eng.step

    def timed_step():
        t0 = time.perf_counter()
        st = tick_step()
        tick_ms.append((1e3 * (time.perf_counter() - t0), st.admitted == 0 and st.live > 0))
        return st

    eng.step = timed_step
    ops.reset_launch_counts()
    rep = eng.run(reqs, gen)
    counts = ops.launch_counts()
    toks = {r.rid: list(r.out) for r in eng.batcher.finished}
    decode = sorted(ms for ms, pure in tick_ms if pure)
    admit = sorted(ms for ms, pure in tick_ms if not pure)
    med = lambda xs: xs[len(xs) // 2] if xs else float("nan")
    print(f"serve reconfig_every={reconfig_every}: completed={rep.completed}/{rep.requests} "
          f"ticks={rep.ticks} tokens={rep.tokens_out} wall_s={rep.wall_s:.3f} "
          f"tokens_per_s={rep.tokens_per_s:.2f} mean_tick_ms={1e3 * rep.wall_s / rep.ticks:.3f} "
          f"decode_tick_ms median={med(decode):.3f} (n={len(decode)}) "
          f"admit_tick_ms median={med(admit):.3f} (n={len(admit)}) "
          f"reconfig_count={rep.reconfig_count} launches={counts}", flush=True)
    return rep, toks, counts


def profile_serve(torch, params, cfg, plan, reqs, gen, *, slots: int, max_len: int, page: int):
    """Device time by kernel class over one whole serve (``--profile``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ServeConfig, ServeEngine

    scfg = ServeConfig(slots=slots, max_len=max_len, page_size=page, num_devices=4)
    eng = ServeEngine(params, cfg, plan, scfg, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.run(reqs, gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    classes: dict[str, float] = {}
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        name = ev.key
        low = name.lower()
        if "topk_gating" in low or "flash_fwd" in low or "paged_decode" in low:
            cls = "ported kernels"
        elif any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
            cls = "matmul (cuBLAS)"
        elif "memcpy" in low or "memset" in low:
            cls = "copies"
        else:
            cls = "other PyTorch kernels"
        classes[cls] = classes.get(cls, 0.0) + ms
        kernels.append((ms, ev.count, name[:90]))
    busy = sum(classes.values())
    print(f"profile: {rep.ticks} ticks, wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}%), idle {100 * (1 - busy / wall_ms):.1f}%", flush=True)
    for cls, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"profile class {cls}: {ms:.2f} ms ({100 * ms / busy:.1f}% of device time)")
    for ms, n, name in sorted(kernels, reverse=True)[:12]:
        print(f"profile kernel {ms:9.3f} ms x{n:<5} {name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="weights and workload seed")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one serve with torch.profiler and print device time by kernel")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke.py: no src/repro_torch beside {REPO}; run it from a checkout",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.serve.workload import WorkloadGenerator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {len(built)} libraries {built} in {time.perf_counter() - t0:.1f} s "
          f"-> {build.BUILD_DIR}", flush=True)

    slots, max_len, page = 4, 256, 16
    cfg = dataclasses.replace(get_config("grok-1-314b"), num_layers=LAYERS)
    plan = make_plan(None)
    gen = WorkloadGenerator("chat", seed=args.seed, vocab_size=cfg.vocab_size)
    out_cap = max(1, min(12, max_len // 4))
    reqs = [
        dataclasses.replace(
            r, prompt_len=max(1, min(r.prompt_len, max_len - out_cap - 2)),
            max_new_tokens=min(r.max_new_tokens, out_cap),
        )
        for r in gen.generate(REQUESTS)
    ]
    prompt_lens = [r.prompt_len for r in reqs]
    rows = kernel_phase(torch, cfg, prompt_lens, slots, page, max_len, args.seed)

    t0 = time.perf_counter()
    params = init_model(args.seed, cfg, plan, device="cuda")
    torch.cuda.synchronize()
    print(f"model: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"experts={cfg.moe.num_experts} top{cfg.moe.top_k} d_ff={cfg.moe.d_ff} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers}/64, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)

    probe = gen.prompt_tokens(reqs[0])
    probe = probe if len(probe) >= 40 else probe.repeat(-(-40 // len(probe)))[:40]
    rel = decode_vs_prefill(torch, params, cfg, plan, probe[:64].astype("int32"), page)
    print(f"check: paged decode vs full prefill logits, max |diff| / max |logit| = {rel:.3e}",
          flush=True)

    rep_off, toks_off, counts_off = serve(torch, params, cfg, plan, reqs, gen, reconfig_every=0,
                                          slots=slots, max_len=max_len, page=page)
    rep_on, toks_on, counts_on = serve(torch, params, cfg, plan, reqs, gen, reconfig_every=4,
                                       slots=slots, max_len=max_len, page=page)
    assert rep_off.completed == len(reqs) == rep_on.completed, "not every request completed"
    assert rep_on.reconfig_count > 0, "the control plane never reconfigured"
    assert toks_on == toks_off, "reconfiguration changed the generated tokens"
    assert all(0 <= t < cfg.vocab_size for out in toks_on.values() for t in out)
    for counts in (counts_off, counts_on):
        missing = [n for n, c in counts.items() if c == 0]
        assert not missing, f"kernels never launched while serving: {missing}"
    print(f"serve: tokens bit-identical with reconfiguration off and on "
          f"({rep_on.reconfig_count} reconfigurations)", flush=True)
    if args.profile:
        profile_serve(torch, params, cfg, plan, reqs, gen, slots=slots, max_len=max_len, page=page)

    line = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        r = rows[name]
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts_on[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
        ))
    assert all(math.isfinite(v) for r in line for k, v in r.items() if k.endswith("ms"))
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
