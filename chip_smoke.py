#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the build of the CUDA kernels from ``src/repro_torch/
   csrc`` with ``nvcc`` (timed).
2. Kernel parity: each hand-written kernel against its plain PyTorch
   version on the card, at the main path's shapes and at edge cases
   (GQA groups of 1 and 2, dq != dv, lengths 0 / 1 / mid-tile /
   mid-page, finite garbage past the lengths, sentinel page ids, S < T).
   Tolerance: max abs error <= 2e-5 (float32, unit-scale inputs).
3. Kernel timing at the main path's shapes: CUDA events over repeated
   launches with rotating input copies (so K/V come from HBM, as on the
   main path), beside the plain version's time, the time of one PyTorch
   library call on the same work (``scaled_dot_product_attention``, or
   none for the paged layout) and the bound: the larger of the bytes the
   call must move over 3.35 TB/s and its float32 FLOPs over 67 TFLOP/s
   (H100 SXM data sheet).
4. The main path at gpt2-xl's full width (48 layers, d_model 1600, 25
   heads, vocab 50257), random weights from seed 0: scoring before and
   after ``clover_decompose`` (function preserved: max |dlogits| <=
   1e-3 max |logits|), ``clover_prune`` to ranks 32/32 with the scoring
   loss before and after, then 8 greedy requests (prompts of 16-400
   tokens, 32 new tokens) served by ``Engine`` dense and paged (pool
   small enough to preempt), each stream equal to ``greedy_reference``
   token for token (a divergence passes only where the reference's
   top-two logits are within 1e-4 max |logit|).  Every kernel's launch
   count must grow in its phase and the plain versions' counts stay 0.

The second-to-last line is one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TOL = 2e-5              # parity: max abs error, float32, unit-scale inputs
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SEED = 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smoke = Smoke(torch)
    smoke.run()
    if smoke.failures:
        print("FAILED:\n  " + "\n  ".join(smoke.failures))
        return 1
    print(json.dumps({"kernels": smoke.kernel_rows()}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.failures: list = []
        self.err = {}        # kernel -> max abs err over parity cases
        self.times = {}      # kernel -> (ms, plain_ms, library_ms, bound)
        self.launches = {}

    # -- helpers -------------------------------------------------------
    def fail(self, msg: str):
        print(f"FAIL: {msg}")
        self.failures.append(msg)

    def randn(self, *shape, gen):
        return self.torch.randn(shape, generator=gen, device=self.dev)

    def parity(self, kernel: str, case: str, got, want):
        torch = self.torch
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        ok = bool(torch.isfinite(got).all()) and err <= TOL
        print(f"parity {kernel:18s} {case:44s} max_abs_err={err:.3e} "
              f"tol={TOL:.0e} {'ok' if ok else 'FAIL'}")
        self.err[kernel] = max(self.err.get(kernel, 0.0), err)
        if not ok:
            self.fail(f"{kernel} {case}: max_abs_err {err:.3e} > {TOL}")

    def time_ms(self, fns, iters: int = 20) -> float:
        """Mean ms per call, cycling through ``fns`` (one per input copy)."""
        torch = self.torch
        for f in fns:
            f()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        n = max(iters, len(fns))
        e0.record()
        for i in range(n):
            fns[i % len(fns)]()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    @staticmethod
    def copies(bytes_per_set: int) -> int:
        """Input copies to rotate through so a launch finds its inputs
        outside the 50 MB L2."""
        return max(2, min(16, math.ceil(128e6 / max(1, bytes_per_set))))

    @staticmethod
    def counted():
        """(function, counter attribute) of each kernel wrapper (launch
        counts) and each plain version (call counts), by name."""
        from repro_torch.kernels import ref
        from repro_torch.kernels.clover_attention import flash_attention
        from repro_torch.kernels.decode_attention import flash_decode
        from repro_torch.kernels.paged_decode_attention import \
            paged_flash_decode
        out = {f.__name__: (f, "launches") for f in
               (flash_attention, flash_decode, paged_flash_decode)}
        out.update({f.__name__: (f, "calls") for f in
                    (ref.attention_ref, ref.decode_attention_ref,
                     ref.paged_decode_attention_ref)})
        return out

    def counts(self):
        return {name: getattr(f, attr)
                for name, (f, attr) in self.counted().items()}

    def reset_counts(self):
        for f, attr in self.counted().values():
            setattr(f, attr, 0)

    # -- phases --------------------------------------------------------
    def run(self):
        self.phase_card()
        self.phase_parity()
        if self.failures:
            return
        self.phase_timing()
        self.phase_main_path()

    def phase_card(self):
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        self.card = smi.stdout.strip().splitlines()[0] if smi.stdout else \
            "nvidia-smi unavailable"
        print(self.card)            # name, power limit: nvidia-smi's own line
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}")
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        path = _build.build()
        _build.lib()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s -> "
              f"{path.relative_to(ROOT)}")

    # ---- phase 2 -----------------------------------------------------
    def phase_parity(self):
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.clover_attention import flash_attention
        from repro_torch.kernels.decode_attention import flash_decode
        from repro_torch.kernels.paged_decode_attention import \
            paged_flash_decode
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED)
        scale = 1.0 / math.sqrt(64)

        # flash attention: (B, S, T, H, KV, dq, dv)
        for B, S, T, H, KV, dq, dv in [
                (4, 1024, 1024, 25, 25, 32, 32),   # main path, scoring
                (1, 432, 432, 25, 25, 32, 32),     # greedy_reference
                (2, 300, 300, 25, 25, 64, 64),     # before pruning
                (2, 100, 100, 4, 2, 32, 24),       # G=2, dq != dv
                (2, 37, 100, 4, 2, 64, 48),        # S < T
                (3, 1, 5, 2, 1, 16, 8),            # one query, G=2
                (1, 70, 70, 2, 2, 256, 256)]:      # widest heads
            q = self.randn(B, S, H, dq, gen=gen)
            k = self.randn(B, T, KV, dq, gen=gen)
            v = self.randn(B, T, KV, dv, gen=gen)
            self.parity("flash_attention",
                        f"B{B} S{S} T{T} H{H} KV{KV} dq{dq} dv{dv}",
                        flash_attention(q, k, v, scale=scale),
                        ref.attention_ref(q, k, v, scale=scale))

        # dense decode: (B, T, H, KV, dq, dv, lengths)
        for B, T, H, KV, dq, dv, lens in [
                (4, 576, 25, 25, 32, 32, [300, 200, 150, 60]),   # main
                (6, 100, 4, 2, 32, 24, [0, 1, 31, 33, 64, 100]),
                (3, 100, 2, 2, 32, 32, [0, 7, 99]),
                (2, 80, 8, 2, 256, 256, [80, 45])]:
            q = self.randn(B, H, dq, gen=gen)
            k = self.randn(B, T, KV, dq, gen=gen)
            v = self.randn(B, T, KV, dv, gen=gen)
            lengths = torch.tensor(lens, dtype=torch.int32, device=self.dev)
            past = (torch.arange(T, device=self.dev)[None, :]
                    >= lengths[:, None].long())[..., None, None]
            k = torch.where(past, torch.full_like(k, 50.0), k)   # garbage
            v = torch.where(past, torch.full_like(v, -50.0), v)
            self.parity("flash_decode",
                        f"B{B} T{T} H{H} KV{KV} dq{dq} dv{dv} len{lens}",
                        flash_decode(q, k, v, lengths, scale=scale),
                        ref.decode_attention_ref(q, k, v, lengths,
                                                 scale=scale))

        # paged decode: (B, H, KV, dq, dv, pt, n_pages, n_p, lengths)
        for B, H, KV, dq, dv, pt, n_pages, n_p, lens in [
                (4, 25, 25, 32, 32, 16, 48, 36, [300, 200, 150, 60]),
                (6, 4, 2, 32, 24, 16, 40, 8, [0, 1, 15, 16, 17, 40]),
                (3, 2, 1, 64, 32, 8, 30, 10, [0, 9, 80])]:
            q, kp, vp, tab, lengths = self.paged_case(
                gen, B, H, KV, dq, dv, pt, n_pages, n_p, lens)
            self.parity("paged_flash_decode",
                        f"B{B} H{H} KV{KV} dq{dq} dv{dv} pt{pt} len{lens}",
                        paged_flash_decode(q, kp, vp, tab, lengths,
                                           scale=scale),
                        ref.paged_decode_attention_ref(q, kp, vp, tab,
                                                       lengths, scale=scale))

    def paged_case(self, gen, B, H, KV, dq, dv, pt, n_pages, n_p, lens):
        """Pool with a garbage row ``n_pages`` full of finite garbage;
        each row maps ceil(len/pt) distinct random pages, the rest of
        its table is the sentinel id."""
        torch = self.torch
        N = n_pages + 1
        q = self.randn(B, H, dq, gen=gen)
        kp = self.randn(N, pt, KV, dq, gen=gen)
        vp = self.randn(N, pt, KV, dv, gen=gen)
        kp[n_pages] = 50.0
        vp[n_pages] = -50.0
        perm = torch.randperm(n_pages, generator=gen, device=self.dev).cpu()
        tab = torch.full((B, n_p), n_pages, dtype=torch.int32)
        nxt = 0
        for b, n in enumerate(lens):
            used = -(-n // pt)
            tab[b, :used] = perm[nxt:nxt + used].to(torch.int32)
            nxt += used
        assert nxt <= n_pages
        lengths = torch.tensor(lens, dtype=torch.int32, device=self.dev)
        return q, kp, vp, tab.to(self.dev), lengths

    # ---- phase 3 -----------------------------------------------------
    def phase_timing(self):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import ref
        from repro_torch.kernels.clover_attention import flash_attention
        from repro_torch.kernels.decode_attention import flash_decode
        from repro_torch.kernels.paged_decode_attention import \
            paged_flash_decode
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 1)
        scale = 1.0 / math.sqrt(64)

        def bound(nbytes, flops):
            tb = nbytes / HBM_BYTES_PER_S * 1e3
            tf = flops / FP32_FLOPS * 1e3
            return (max(tb, tf), "bytes" if tb >= tf else "operations")

        # flash: scoring batch of the pruned model
        B, S, H, d = 4, 1024, 25, 32
        per_set = 4 * 4 * B * S * H * d
        sets = [[self.randn(B, S, H, d, gen=gen) for _ in range(3)]
                for _ in range(self.copies(per_set))]
        pairs = B * H * S * (S + 1) // 2
        bnd = bound(per_set, pairs * 2 * (d + d))
        sdpa = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
                for q, k, v in sets]
        self.times["flash_attention"] = (
            self.time_ms([lambda s=s: flash_attention(*s, scale=scale)
                          for s in sets]),
            self.time_ms([lambda s=s: ref.attention_ref(*s, scale=scale)
                          for s in sets], iters=5),
            self.time_ms([lambda s=s: F.scaled_dot_product_attention(
                *s, is_causal=True, scale=scale) for s in sdpa]),
            bnd, f"B{B} S{S} H{H} dq{d} dv{d}")

        # dense decode: 4 slots against the engine's 576-position caches
        B, T, H, d = 4, 576, 25, 32
        lens = [300, 200, 150, 60]
        lengths = torch.tensor(lens, dtype=torch.int32, device=self.dev)
        per_set = 4 * (2 * B * T * H * d)
        sets = [(self.randn(B, H, d, gen=gen), self.randn(B, T, H, d, gen=gen),
                 self.randn(B, T, H, d, gen=gen))
                for _ in range(self.copies(per_set))]
        tot = sum(lens)
        nbytes = 4 * (B * H * d + tot * H * 2 * d + B + B * H * d)
        bnd = bound(nbytes, tot * H * 2 * (d + d))
        mask = (torch.arange(T, device=self.dev)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        sdpa = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2))
                for q, k, v in sets]
        self.times["flash_decode"] = (
            self.time_ms([lambda s=s: flash_decode(*s, lengths, scale=scale)
                          for s in sets]),
            self.time_ms([lambda s=s: ref.decode_attention_ref(
                *s, lengths, scale=scale) for s in sets]),
            self.time_ms([lambda s=s: F.scaled_dot_product_attention(
                *s, attn_mask=mask, scale=scale) for s in sdpa]),
            bnd, f"B{B} T{T} H=KV={H} dq=dv={d} lengths {lens}")

        # paged decode: the engine's pool (48 pages of 16 + garbage row)
        pt, n_pages, n_p = 16, 48, 36
        cases = [self.paged_case(gen, B, H, H, d, d, pt, n_pages, n_p, lens)
                 for _ in range(self.copies(
                     4 * 2 * (n_pages + 1) * pt * H * d))]
        pages = sum(-(-n // pt) for n in lens)
        nbytes = 4 * (B * H * d + tot * H * 2 * d + B + pages + B * H * d)
        bnd = bound(nbytes, tot * H * 2 * (d + d))
        self.times["paged_flash_decode"] = (
            self.time_ms([lambda c=c: paged_flash_decode(*c, scale=scale)
                          for c in cases]),
            self.time_ms([lambda c=c: ref.paged_decode_attention_ref(
                *c, scale=scale) for c in cases]),
            None, bnd,
            f"B{B} pt{pt} pool {n_pages}+1 pages H=KV={H} dq=dv={d} "
            f"lengths {lens}")
        for name, (ms, plain, lib, (bms, by), shape) in self.times.items():
            libs = "n/a" if lib is None else f"{lib:.4f}"
            print(f"time {name:18s} {shape}: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, library {libs} ms, bound {bms:.4f} ms "
                  f"({by}) [{self.card}]")

    # ---- phase 4 -----------------------------------------------------
    def phase_main_path(self):
        import numpy as np
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.configs import get_config
        from repro_torch.core.decompose import clover_decompose
        from repro_torch.core.prune import clover_prune
        from repro_torch.models.transformer import forward, init_lm_params
        from repro_torch.serve import (Engine, EngineConfig, Request,
                                       greedy_reference)

        cfg = get_config("gpt2-xl")
        self.reset_counts()
        marks = [("start", self.counts())]

        t0 = time.perf_counter()
        params = init_lm_params(cfg, SEED)
        n = sum(t.numel() for t in _leaves(params))
        print(f"gpt2-xl init: {n} float32 parameters on the card "
              f"({time.perf_counter() - t0:.1f} s)")
        if n != cfg.n_params():
            self.fail(f"parameter count {n} != {cfg.n_params()}")
        tokens = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (4, 1024))

        def loss(logits):
            return F.cross_entropy(
                logits[:, :-1].reshape(-1, logits.shape[-1]),
                torch.as_tensor(tokens[:, 1:], device=self.dev).reshape(-1)
            ).item()

        logits0, _ = forward(params, cfg, tokens)
        dparams, dcfg, _ = clover_decompose(params, cfg)
        del params
        logits1, _ = forward(dparams, dcfg, tokens)
        dmax = (logits1 - logits0).abs().max().item()
        lmax = logits0.abs().max().item()
        del logits0
        print(f"clover_decompose: max|dlogits| {dmax:.3e} vs 1e-3 * "
              f"max|logits| = {1e-3 * lmax:.3e}")
        if not dmax <= 1e-3 * lmax:
            self.fail("clover_decompose did not preserve the function")
        loss_full = loss(logits1)
        del logits1
        pparams, pcfg = clover_prune(dparams, dcfg, qk_ratio=0.5,
                                     vo_ratio=0.5)
        del dparams
        if (pcfg.qk_dim, pcfg.vo_dim) != (32, 32):
            self.fail(f"pruned ranks {(pcfg.qk_dim, pcfg.vo_dim)} != (32, 32)")
        logits2, _ = forward(pparams, pcfg, tokens)
        loss_pruned = loss(logits2)
        del logits2
        print(f"scoring loss on (4, 1024) random tokens: decomposed "
              f"{loss_full:.6f}, pruned 32/32 {loss_pruned:.6f}")
        marks.append(("scoring", self.counts()))

        rng = np.random.default_rng(SEED + 1)
        lens = [16, 400, 57, 233, 120, 310, 31, 180]
        prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
                   for L in lens]
        runs = {}
        for name, ek in (
                ("dense", dict(slots=4, max_len=512, prefill_chunk=64)),
                ("paged", dict(slots=4, max_len=512, prefill_chunk=64,
                               paged=True, page_tokens=16, n_pages=48))):
            eng = Engine(pparams, pcfg, EngineConfig(**ek))
            reqs = [Request(uid=i, prompt=p, max_new_tokens=32)
                    for i, p in enumerate(prompts)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_tok = sum(len(r.generated) for r in reqs)
            itl = [d for r in reqs for d in np.diff(r.token_times)]
            print(f"engine {name}: {n_tok} tokens in {wall:.3f} s = "
                  f"{n_tok / wall:.1f} tokens/s, mean ITL "
                  f"{1e3 * float(np.mean(itl)):.2f} ms, {eng.steps} steps, "
                  f"preemptions {eng.sched.preemptions}, compiled shapes "
                  f"{eng.compiled_shapes()} [{self.card}]")
            if eng.compiled_shapes() != 2:
                self.fail(f"{name}: compiled_shapes {eng.compiled_shapes()}")
            if not all(r.done for r in reqs):
                self.fail(f"{name}: requests left unfinished")
            if name == "paged" and eng.sched.preemptions < 1:
                self.fail("paged: the undersized pool never preempted")
            runs[name] = reqs
            del eng
            marks.append((name, self.counts()))

        t0 = time.perf_counter()
        refs = [greedy_reference(pparams, pcfg, p, 32) for p in prompts]
        torch.cuda.synchronize()
        print(f"greedy_reference: {len(refs)} streams in "
              f"{time.perf_counter() - t0:.1f} s")
        marks.append(("reference", self.counts()))
        for name, reqs in runs.items():
            self.compare_streams(name, reqs, refs, prompts, pparams, pcfg,
                                 forward)
        self.check_counts(marks)
        self.phase_profile(pparams, pcfg, prompts)

    def phase_profile(self, params, cfg, prompts):
        """Where the dense engine's time goes: its first 4 requests again
        (16 new tokens each) under torch.profiler, outside the counted
        main path.  Device busy time sums the kernels (not the CPU ops
        or the step spans that contain them)."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.serve import Engine, EngineConfig, Request
        eng = Engine(params, cfg, EngineConfig(slots=4, max_len=512,
                                               prefill_chunk=64))
        reqs = [Request(uid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts[:4])]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run(reqs)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("engine.")]

        def dev_ms(e):
            return e.self_device_time_total / 1e3

        busy = sum(dev_ms(e) for e in kernels)
        print(f"profile dense engine, 4 requests x 16 tokens (profiler on): "
              f"wall {wall_ms:.1f} ms, {eng.steps} steps, kernels busy "
              f"{busy:.1f} ms = {busy / wall_ms:.1%} of wall, idle "
              f"{1 - busy / wall_ms:.1%} [{self.card}]")
        for e in events:
            if e.key.startswith("engine.") and e.device_type == \
                    DeviceType.CPU:
                print(f"  {e.key}: {e.count} steps, host "
                      f"{e.cpu_time_total / 1e3 / e.count:.2f} ms/step")
        for e in sorted(kernels, key=dev_ms, reverse=True)[:10]:
            print(f"  kernel {dev_ms(e):8.2f} ms ({dev_ms(e) / busy:6.1%}) "
                  f"x{e.count:<6d} {e.key[:80]}")

    def compare_streams(self, name, reqs, refs, prompts, params, cfg,
                        forward):
        import numpy as np
        exact = 0
        for r, want, prompt in zip(reqs, refs, prompts):
            got = r.generated
            if got == want:
                exact += 1
                continue
            i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            seq = np.asarray([list(prompt) + want[:i]], np.int64)
            logits, _ = forward(params, cfg, seq, last_only=True)
            row = logits[0, -1]
            top2 = row.topk(2).values
            gap = (top2[0] - top2[1]).item()
            tie = 1e-4 * row.abs().max().item()
            verdict = "near-tie, allowed" if gap < tie else "DIVERGED"
            print(f"{name} uid {r.uid}: first difference at token {i} "
                  f"(engine {got[i]}, reference {want[i]}), reference "
                  f"top-2 gap {gap:.3e} vs near-tie bound {tie:.3e}: "
                  f"{verdict}")
            if gap >= tie:
                self.fail(f"{name} uid {r.uid} diverged from "
                          "greedy_reference")
        print(f"{name}: {exact}/{len(reqs)} streams token-identical to "
              "greedy_reference")

    def check_counts(self, marks):
        phase_kernel = {"scoring": "flash_attention",
                        "dense": "flash_decode",
                        "paged": "paged_flash_decode",
                        "reference": "flash_attention"}
        for (_, before), (name, after) in zip(marks, marks[1:]):
            k = phase_kernel[name]
            grew = after[k] - before[k]
            print(f"phase {name}: {k} launched {grew} times")
            if grew <= 0:
                self.fail(f"{k} never launched in phase {name}")
        end = marks[-1][1]
        for name in ("attention_ref", "decode_attention_ref",
                     "paged_decode_attention_ref"):
            if end[name] != 0:
                self.fail(f"plain version {name} ran {end[name]} times on "
                          "the main path")
        self.launches = {k: end[k] for k in
                         ("flash_attention", "flash_decode",
                          "paged_flash_decode")}
        print(f"main-path launches: {self.launches}")

    def kernel_rows(self):
        meta = {
            "flash_attention": ("src/repro_torch/csrc/clover_attention.cu",
                                "src/repro/kernels/clover_attention.py:82"),
            "flash_decode": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:245"),
            "paged_flash_decode": (
                "src/repro_torch/csrc/decode_attention.cu",
                "src/repro/kernels/paged_decode_attention.py:247"),
        }
        rows = []
        for name, (source, replaces) in meta.items():
            ms, plain, lib, (bms, by), _ = self.times[name]
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces,
                         "launches": self.launches[name],
                         "max_abs_err": self.err[name], "ms": ms,
                         "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                         "library_ms": lib})
        return rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
