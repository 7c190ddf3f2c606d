"""Chip smoke test of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (PATH or /usr/local/cuda/bin) and this
checkout; imports nothing of JAX or ``ray_tpu``. Phases, each of which
passes or exits non-zero:

1. prints the card's name and power limit, builds the kernels from
   ``ray_tpu_torch/csrc`` and prints the build time and ptxas report;
2. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at edge cases, and times kernel, plain version
   and (for flash) ``scaled_dot_product_attention`` as a yardstick;
3. runs ``forward`` of ``ModelConfig()`` at B=4, T=2048 (flash launches
   counted from zero), and checks an f32 forward on the card against the
   CPU's plain path;
4. serves 8 greedy requests and one at temperature 0.8 through
   ``ContinuousBatchingEngine(ModelConfig())`` at its defaults (paged
   launches counted from zero), prints decode tokens/s, and checks that an
   f32 engine on the card (kernel) gives the same greedy tokens as the
   same engine on the CPU (plain version);
5. prints the kernel table as one JSON line, then the result line.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; the port's smoke test needs one GPU",
          file=sys.stderr)
    sys.exit(2)

from ray_tpu_torch import _cuda  # noqa: E402
from ray_tpu_torch.llm.continuous import ContinuousBatchingEngine  # noqa: E402
from ray_tpu_torch.llm.engine import GenerationConfig  # noqa: E402
from ray_tpu_torch.models import transformer as tfm  # noqa: E402
from ray_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_forward,
    flash_attention_reference,
)
from ray_tpu_torch.ops.layers import attention_reference  # noqa: E402
from ray_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_attention_decode,
    paged_attention_reference,
)

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per dtype


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float, dtype: torch.dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEV).manual_seed(seed)


# ---------------------------------------------------------------------------
# 1. card, build
# ---------------------------------------------------------------------------
def phase_card_and_build() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.monotonic()
    built = _cuda.build_all()
    print(f"build: {time.monotonic() - t0:.1f} s for {sorted(built) or 'nothing (cached)'}")
    for src in _cuda.SOURCES:
        log = _cuda._library_path(src).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------
def flash_case(name, b, t, h, hkv, d, causal, dtype, atol, seed, expect_launch=True):
    g = gen(seed)
    q = torch.randn(b, t, h, d, generator=g, device=DEV).to(dtype)
    k = torch.randn(b, t, hkv, d, generator=g, device=DEV).to(dtype)
    v = torch.randn(b, t, hkv, d, generator=g, device=DEV).to(dtype)
    before = flash_attention_forward.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    launched = flash_attention_forward.launches - before
    ref = attention_reference(q.float(), k.float(), v.float(), causal=causal)
    err = max_err(out, ref)
    print(f"flash {name}: max_abs_err {err:.3e} (atol {atol}) launches {launched}")
    check(err <= atol and math.isfinite(err), f"flash {name} error {err} > {atol}")
    check(launched == (1 if expect_launch else 0), f"flash {name}: {launched} launches")


def phase_flash():
    """Edge cases through the wrapper against attention_reference in f32,
    then the kernel against its plain version at the forward's shapes."""
    flash_case("f32 causal", 2, 256, 4, 4, 64, True, torch.float32, 1e-4, 1)
    flash_case("f32 non-causal", 2, 256, 4, 4, 64, False, torch.float32, 1e-4, 2)
    flash_case("f32 GQA hd32", 1, 128, 8, 2, 32, True, torch.float32, 1e-4, 3)
    flash_case("f32 ragged causal T=100", 1, 100, 4, 2, 64, True, torch.float32, 1e-4, 4)
    flash_case("f32 ragged non-causal T=100 (plain branch)", 1, 100, 4, 2, 64, False,
               torch.float32, 1e-4, 5, expect_launch=False)
    # bf16 against the f32 reference of the same bf16 inputs: bf16 rounding
    # of q*scale, P and O bounds the error (O is an average of N(0,1) values)
    flash_case("bf16 GQA causal", 2, 512, 8, 4, 64, True, torch.bfloat16, 3e-2, 6)
    flash_case("bf16 ragged causal T=2000", 1, 2000, 8, 4, 64, True, torch.bfloat16, 3e-2, 7)
    flash_case("bf16 entry() shape hd32", 4, 128, 8, 4, 32, True, torch.bfloat16, 3e-2, 8)

    # the forward's shapes: B=4, T=2048, 8 heads over 4 KV heads, hd 64, bf16
    b, t, hd, bh = 4, 2048, 64, 4 * 8
    g = gen(11)
    qg, kg, vg = (torch.randn(bh, t, hd, generator=g, device=DEV).to(torch.bfloat16)
                  for _ in range(3))
    rows = {}
    for causal in (True, False):
        out, lse = flash_attention_forward(qg, kg, vg, causal)
        ref_out, ref_lse = flash_attention_reference(qg, kg, vg, causal)
        torch.cuda.synchronize()
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        ms = time_ms(lambda: flash_attention_forward(qg, kg, vg, causal))
        plain = time_ms(lambda: flash_attention_reference(qg, kg, vg, causal), iters=5)
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qg[None], kg[None], vg[None], is_causal=causal))
        pairs = bh * (t * (t + 1) // 2 if causal else t * t)
        bnd, by = bound_ms(nbytes(qg, kg, vg, out, lse), 4.0 * hd * pairs, torch.bfloat16)
        print(f"flash bf16 bh={bh} T={t} D={hd} causal={causal}: out err {e_out:.3e} "
              f"lse err {e_lse:.3e}; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"sdpa {sdpa:.4f} ms, bound {bnd:.4f} ms ({by})")
        check(e_out <= 3e-2 and e_lse <= 1e-3, f"flash forward shapes: {e_out}, {e_lse}")
        rows[causal] = dict(max_abs_err=e_out, ms=ms, plain_ms=plain, bound_ms=bnd,
                            bound_by=by, library_ms=sdpa)
    return rows[True]  # the forward is causal


def paged_inputs(b, kh, g, d, n_pages, page, p_max, lengths, dtype, seed, share=False):
    gn = gen(seed)
    q = torch.randn(b, kh, g, d, generator=gn, device=DEV).to(dtype)
    kp = torch.randn(kh, n_pages, page, d, generator=gn, device=DEV).to(dtype)
    vp = torch.randn(kh, n_pages, page, d, generator=gn, device=DEV).to(dtype)
    if b * p_max < n_pages:  # distinct pages per slot, as the engine allocates them
        perm = torch.randperm(n_pages - 1, generator=gn, device=DEV)[: b * p_max] + 1
        tables = perm.reshape(b, p_max).to(torch.int32)
    else:  # tests/test_paged_attention.py draws pages with replacement
        tables = torch.randint(0, n_pages, (b, p_max), generator=gn, device=DEV,
                               dtype=torch.int32)
    if share:
        tables[1] = tables[0]
        q[1] = q[0]
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    return q, kp, vp, tables, lens


def paged_case(name, args, page, atol):
    before = paged_attention_decode.launches
    out = paged_attention_decode(*args, page_size=page)
    ref = paged_attention_reference(*args, page_size=page)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    print(f"paged {name}: max_abs_err {err:.3e} (atol {atol}) "
          f"launches {paged_attention_decode.launches - before}")
    check(err <= atol and math.isfinite(err), f"paged {name} error {err} > {atol}")
    return out


def paged_timing(name, args, page, dtype):
    q, kp, vp, tables, lens = args
    kh, d = q.shape[1], q.shape[3]
    ms = time_ms(lambda: paged_attention_decode(*args, page_size=page))
    plain = time_ms(lambda: paged_attention_reference(*args, page_size=page), iters=5)
    total_len = lens.long().clamp(max=tables.shape[1] * page).sum().item()
    kv_bytes = 2 * total_len * kh * d * kp.element_size()
    n_bytes = kv_bytes + 2 * nbytes(q) + nbytes(lens) + 4 * total_len // page
    flops = 4.0 * q.shape[2] * d * kh * total_len
    bnd, by = bound_ms(n_bytes, flops, dtype)
    print(f"paged {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms "
          f"({by}), {n_bytes / ms / 1e6:.1f} GB/s")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)


def phase_paged():
    f32, bf16 = torch.float32, torch.bfloat16
    # tests/test_paged_attention.py's cases, f32 and bf16 (bf16: P and
    # q*scale are rounded in the kernel, not in the plain f32 gather)
    for dtype, atol in ((f32, 2e-5), (bf16, 2e-2)):
        tag = "f32" if dtype == f32 else "bf16"
        paged_case(f"{tag} ragged", paged_inputs(4, 2, 2, 32, 16, 8, 4, [5, 17, 32, 1],
                                                 dtype, 21), 8, atol)
        paged_case(f"{tag} single/full pages",
                   paged_inputs(4, 2, 2, 64, 16, 8, 4, [1, 8, 16, 32], dtype, 22), 8, atol)
        out = paged_case(f"{tag} shared pages",
                         paged_inputs(4, 2, 2, 64, 16, 8, 4, [24, 24, 9, 3], dtype, 23,
                                      share=True), 8, atol)
        check(max_err(out[0], out[1]) == 0.0, f"paged {tag}: shared pages differ")
        paged_case(f"{tag} hd128 G4", paged_inputs(3, 2, 4, 128, 64, 16, 4, [50, 64, 1],
                                                   dtype, 24), 16, atol)
    # the large configuration: 256 slots x 512 pages of 16 (8192 positions)
    lens = torch.randint(1, 512 * 16 + 1, (256,), generator=torch.Generator().manual_seed(5))
    big = paged_inputs(256, 4, 2, 64, 256 * 512 + 1, 16, 512, lens.tolist(), bf16, 25)
    paged_case("bf16 B=256 P_max=512", big, 16, 2e-2)
    paged_timing("bf16 B=256 P_max=512", big, 16, bf16)
    del big
    # the engine's decode step: B=8, 4 KV heads x 2, hd 64, 256 pages of 16,
    # P_max 128, at the lengths of the serving phase's mid-point
    main = paged_inputs(8, 4, 2, 64, 256, 16, 128, [128, 140, 113, 159, 97, 150, 131, 120],
                        bf16, 26)
    out = paged_attention_decode(*main, page_size=16)
    err = max_err(out, paged_attention_reference(*main, page_size=16))
    check(err <= 2e-2, f"paged engine shapes error {err}")
    row = paged_timing("bf16 engine shapes B=8 P_max=128", main, 16, bf16)
    row["max_abs_err"] = err
    return row


# ---------------------------------------------------------------------------
# 3. model forward
# ---------------------------------------------------------------------------
def phase_forward() -> int:
    cfg = tfm.ModelConfig()
    params = tfm.init_params(cfg, gen(0), DEV)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen(1), device=DEV)
    flash_attention_forward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = tfm.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = flash_attention_forward.launches
    check(tuple(logits.shape) == (4, 2048, cfg.vocab_size), f"logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(launches > 0, "forward did not launch the flash kernel")
    ms = time_ms(lambda: tfm.forward(params, tokens, cfg), iters=5, warmup=1)
    print(f"forward ModelConfig() B=4 T=2048 bf16: first {dt * 1e3:.1f} ms, steady {ms:.2f} ms, "
          f"flash launches {launches}")
    device_profile("forward ModelConfig() B=4 T=2048", lambda: tfm.forward(params, tokens, cfg), 3)
    del logits, params

    # f32 on the card (flash kernel) against the CPU's plain path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = tfm.ModelConfig(dtype=torch.float32)
    p_cpu = tfm.init_params(cfg32, torch.Generator().manual_seed(2), "cpu")
    p_gpu = tfm.params_to(p_cpu, DEV)
    tok = torch.randint(0, cfg32.vocab_size, (1, 256), generator=torch.Generator().manual_seed(3))
    want = tfm.forward(p_cpu, tok, cfg32)
    got = tfm.forward(p_gpu, tok.to(DEV), cfg32).cpu()
    err = max_err(got, want)
    print(f"forward f32 B=1 T=256 card vs CPU plain path: max_abs_err {err:.3e} (atol 1e-3)")
    check(err <= 1e-3, f"f32 forward card vs CPU error {err}")
    return launches


# ---------------------------------------------------------------------------
# 4. serving
# ---------------------------------------------------------------------------
def prompts(cfg, n=8, length=96, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=length).tolist() for _ in range(n)]


def device_profile(label: str, fn, steps: int) -> None:
    """Where ``fn``'s time goes: torch.profiler over ``steps`` calls; the
    device busy share is the summed kernel time over the wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    if not rows:
        print(f"{label} profile: no device time in the trace (not measured)")
        return
    busy_us = sum(r[0] for r in rows)
    print(f"{label} profile over {steps} calls: wall {wall_us / steps:.1f} us/call, "
          f"device busy {busy_us / steps:.1f} us/call ({100 * busy_us / wall_us:.1f}%), "
          f"{sum(r[1] for r in rows) // steps} device ops/call")
    for us, count, key in sorted(rows, reverse=True)[:6]:
        print(f"  {us / steps:9.1f} us/call  x{count // steps:<4d} {key[:90]}")


def profile_decode(eng, ps, gen_cfg) -> None:
    """Profile decode steps of a full batch of 8 slots."""
    for p in ps:
        eng.submit(p, gen_cfg)
    eng._admit()
    eng.step()
    device_profile("decode step, 8 slots", eng.step, 8)
    while eng.pending():
        eng.step()
    eng.results.clear()


def phase_serve():
    cfg = tfm.ModelConfig()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), DEV)
    eng = ContinuousBatchingEngine(cfg, params)
    greedy = GenerationConfig(max_new_tokens=64)
    sampled = GenerationConfig(max_new_tokens=64, temperature=0.8, seed=17)
    ps = prompts(cfg)
    # warm the engine's programs on one short request (not counted)
    eng.generate_ids([ps[0][:16]], GenerationConfig(max_new_tokens=4))
    paged_attention_decode.launches = 0
    ids = [eng.submit(p, greedy) for p in ps] + [eng.submit(ps[0], sampled)]
    decode_tokens, decode_s, steps = 0, 0.0, 0
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    while eng.pending():
        eng._admit()  # prefill whatever fits now, outside the decode timing
        torch.cuda.synchronize()
        active = sum(1 for s in eng.slots if s.active)
        t0 = time.perf_counter()
        eng.step()  # admits nothing more; ends in a device-to-host read
        decode_s += time.perf_counter() - t0
        decode_tokens += active  # one token per slot active in the step
        steps += 1
    wall = time.perf_counter() - t_all
    launches = paged_attention_decode.launches
    outs = [eng.results.pop(i) for i in ids]
    check(launches > 0, "serving did not launch the paged kernel")
    check(all(len(o) == 64 for o in outs), f"lengths {[len(o) for o in outs]}")
    check(all(0 <= x < cfg.vocab_size for o in outs for x in o), "token out of vocab")
    check(outs[8] != outs[0], "temperature 0.8 stream equals the greedy one")
    check(eng.pool.free_pages == eng.pool.usable_pages, "pages leaked")
    tps = decode_tokens / decode_s if decode_s else float("nan")
    print(f"serve ModelConfig() 9 requests x 64 tokens: {steps} steps, wall {wall:.3f} s, "
          f"decode {decode_tokens} tokens in {decode_s:.3f} s = {tps:.1f} tokens/s, "
          f"paged launches {launches}")

    profile_decode(eng, ps, greedy)

    # f32: the engine on the card (kernel) against the engine on the CPU
    # (plain gather), token for token; TF32 off so f32 products stay f32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = tfm.ModelConfig(dtype=torch.float32)
    p32 = tfm.init_params(cfg32, torch.Generator().manual_seed(0), "cpu")
    on_card = ContinuousBatchingEngine(cfg32, p32).generate_ids(ps, greedy)
    on_cpu = ContinuousBatchingEngine(cfg32, p32, device="cpu").generate_ids(ps, greedy)
    same = sum(a == b for a, b in zip(on_card, on_cpu))
    print(f"serve f32 card vs CPU (allow_tf32=False): {same}/8 greedy streams token-exact")
    check(same == len(ps), "f32 greedy streams differ between card and CPU")
    return launches, tps


def main() -> None:
    phase_card_and_build()
    flash_row = phase_flash()
    paged_row = phase_paged()
    flash_launches = phase_forward()
    paged_launches, tps = phase_serve()
    kernels = [
        dict(name="paged_attention_decode", route="cuda",
             source="ray_tpu_torch/csrc/paged_attention.cu",
             replaces="ray_tpu/ops/paged_attention.py:102",
             launches=paged_launches, **paged_row),
        dict(name="flash_attention_fwd", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:185",
             launches=flash_launches, **flash_row),
    ]
    print(f"decode tokens/s {tps:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
