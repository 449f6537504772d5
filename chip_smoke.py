"""Drive the PyTorch/CUDA port on one GPU and check its kernels.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero):

1. Build the gallery kernels (``creamfl_tpu_torch/csrc/gallery.cu``) with
   nvcc and print the build seconds.
2. Hold each kernel (K1 row logsumexp, K2 softmax matvec, K3 fused gallery
   CE, K4 con_w diagonal) against its plain PyTorch version on the card at
   the main path's shapes, plus one odd shape, and time kernel, plain
   version and one PyTorch call computing the same function.
3. The image-client half of a CreamFL round at the paper's width: three
   ResNet-18 clients (100 classes, feature_dim 256) take task and contrast
   steps, run a local test and extract features over the full 50 000-row
   public set; then con_w aggregates their representations against
   50 000 x 256 global features. Every kernel must have launched here.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
per-kernel JSON, and before that the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

N_PUB, DIM, N_CLASS = 50_000, 256, 100
PUB_BS, TASK_BS, TAIL_BS = 128, 64, 80
# Depth of the slice run: per client, task steps and full-size contrast
# steps (one ragged contrast step at TAIL_BS follows).
N_CLIENTS, TASK_STEPS, CONTRAST_STEPS = 3, 3, 3

SOURCE = "creamfl_tpu_torch/csrc/gallery.cu"
REPLACES = {
    "row_logsumexp": "creamfl_tpu/ops/pallas_gallery.py:80",
    "softmax_matvec": "creamfl_tpu/ops/pallas_gallery.py:166",
    "fused_gallery_ce": "creamfl_tpu/ops/pallas_gallery.py:212",
    "conw_diag": "creamfl_tpu/ops/pallas_gallery.py:125",
}
# Tolerances of kernel vs plain version, both fp32; they differ only in
# summation order (split-and-merge over gallery tiles vs cuBLAS blocks).
TOL = {
    # lse of up to 50 000 terms is ~11-30: 1e-4 absolute is ~10 ulp.
    "row_logsumexp": dict(rtol=0.0, atol=1e-4),
    "conw_diag": dict(rtol=0.0, atol=1e-4),
    # sums of 50 000 small products; atol covers entries near zero.
    "softmax_matvec": dict(rtol=1e-4, atol=1e-6),
    "dfeats": dict(rtol=1e-4, atol=1e-6),
    # a mean of lse - label logit: relative to the loss value.
    "ce_loss": dict(rtol=1e-5, atol=0.0),
}


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                        else "bytes")


def unit_rows(n: int, d: int, gen: torch.Generator, dev) -> torch.Tensor:
    x = torch.randn(n, d, generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def check(name: str, got: torch.Tensor, want: torch.Tensor, tol) -> float:
    err = (got.double() - want.double()).abs()
    lim = tol["atol"] + tol["rtol"] * want.double().abs()
    worst = float(err.max())
    rel = float((err / want.double().abs().clamp_min(1e-30)).max())
    ok = bool((err <= lim).all()) and bool(torch.isfinite(got).all())
    log(f"  {name}: max_abs_err {worst:.3e} max_rel_err {rel:.3e} "
        f"tol rtol={tol['rtol']} atol={tol['atol']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return worst


# ---------------------------------------------------------------------------
# phase 1 + 2: kernels
# ---------------------------------------------------------------------------

def build_phase() -> None:
    from creamfl_tpu_torch.ops import gallery_kernels as K

    path, seconds, out = K.build()
    log(f"[build] {path.name} in {seconds:.1f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "bytes smem" in line:
            log("  ptxas:", line.strip())


def kernel_phase(seed: int):
    """Kernel vs plain version at the main path's shapes. Returns per-kernel
    records (without launch counts) for the JSON line."""
    from creamfl_tpu_torch.ops import gallery as P
    from creamfl_tpu_torch.ops import gallery_kernels as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    errs = {k: 0.0 for k in REPLACES}
    rec = {}

    def timed(name, kernel, plain, library, flops, nbytes, reps=10):
        ms = cuda_time_ms(kernel, reps)
        plain_ms = cuda_time_ms(plain, reps)
        lib_ms = cuda_time_ms(library, reps)
        b_ms, b_by = bound_ms(flops, nbytes)
        rec[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
        log(f"  time {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"library {lib_ms:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by})")

    # K4 and K1 at con_w's 50 000 x 50 000 x 256 (tau = 1).
    log(f"[kernels] con_w shape {N_PUB} x {N_PUB} x {DIM}")
    v = unit_rows(N_PUB, DIM, gen, dev)
    g = unit_rows(N_PUB, DIM, gen, dev)
    errs["conw_diag"] = check("conw_diag", K.conw_diag(v, g),
                              P.gallery_log_softmax_diag(v, g),
                              TOL["conw_diag"])
    errs["row_logsumexp"] = check("row_logsumexp tau=1",
                                  K.row_logsumexp(v, g, 1.0),
                                  P.streaming_logsumexp(v, g, 1.0),
                                  TOL["row_logsumexp"])
    n, d = N_PUB, DIM
    timed("conw_diag", lambda: K.conw_diag(v, g),
          lambda: P.gallery_log_softmax_diag(v, g),
          lambda: torch.log_softmax(v @ g.T, dim=1).diagonal(),
          2.0 * n * n * d + 2.0 * n * d, 4.0 * (2 * n * d + n), reps=5)
    del v, g
    torch.cuda.empty_cache()

    # K1, K2, K3 at the contrast step's shapes, then one odd shape
    # (D = 48, N a multiple of no tile, M not a multiple of a row block).
    g = unit_rows(N_PUB, DIM, gen, dev)
    cases = [(PUB_BS, g, 0.5, "main"), (TAIL_BS, g, 0.5, "ragged"),
             (77, torch.randn(1001, 48, generator=gen, device=dev), 0.5,
              "odd")]
    for m, gal, tau, tag in cases:
        n, d = gal.shape
        log(f"[kernels] {tag}: M={m} N={n} D={d} tau={tau}")
        f = (unit_rows(m, d, gen, dev) if tag != "odd"
             else torch.randn(m, d, generator=gen, device=dev))
        labels = torch.randint(0, n, (m,), generator=gen, device=dev)
        lse_k = K.row_logsumexp(f, gal, tau)
        lse_p = P.streaming_logsumexp(f, gal, tau)
        errs["row_logsumexp"] = max(errs["row_logsumexp"], check(
            "row_logsumexp", lse_k, lse_p, TOL["row_logsumexp"]))
        errs["softmax_matvec"] = max(errs["softmax_matvec"], check(
            "softmax_matvec", K.softmax_matvec(f, gal, lse_p, tau),
            P.softmax_matvec(f, gal, lse_p, tau), TOL["softmax_matvec"]))
        fk = f.clone().requires_grad_(True)
        fp = f.clone().requires_grad_(True)
        loss_k = K.fused_gallery_ce(fk, gal, labels, tau)
        loss_k.backward()
        loss_p = P.gallery_cross_entropy(fp, gal, labels, tau)
        loss_p.backward()
        e_loss = check("fused_gallery_ce loss", loss_k.detach(),
                       loss_p.detach(), TOL["ce_loss"])
        e_grad = check("fused_gallery_ce dfeats", fk.grad, fp.grad,
                       TOL["dfeats"])
        errs["fused_gallery_ce"] = max(errs["fused_gallery_ce"], e_loss,
                                       e_grad)
        if tag != "main":
            continue
        timed("row_logsumexp", lambda: K.row_logsumexp(f, gal, tau),
              lambda: P.streaming_logsumexp(f, gal, tau),
              lambda: torch.logsumexp(f @ gal.T / tau, dim=1),
              2.0 * m * n * d, 4.0 * (m * d + n * d + m))
        timed("softmax_matvec", lambda: K.softmax_matvec(f, gal, lse_p, tau),
              lambda: P.softmax_matvec(f, gal, lse_p, tau),
              lambda: torch.softmax(f @ gal.T / tau, dim=1) @ gal,
              4.0 * m * n * d, 4.0 * (m * d + n * d + m + m * d))

        def ce(fn):
            def run():
                x = f.detach().requires_grad_(True)
                fn(x).backward()
            return run

        # Bound: a forward and a backward product of M x N x D each (the
        # logits kept from the forward); K3 recomputes them in K2 instead,
        # 2 M N D operations above the bound, to store no M x N logits.
        timed("fused_gallery_ce",
              ce(lambda x: K.fused_gallery_ce(x, gal, labels, tau)),
              ce(lambda x: P.gallery_cross_entropy(x, gal, labels, tau)),
              ce(lambda x: F.cross_entropy(x @ gal.T / tau, labels)),
              4.0 * m * n * d, 4.0 * (2 * m * d + n * d) + 8.0 * m)
        # K3's own launches (K1 forward, K2 backward) without the autograd
        # bookkeeping and small ops around them.
        alone = cuda_time_ms(lambda: K.softmax_matvec(
            f, gal, K.row_logsumexp(f, gal, tau), tau))
        log(f"  time fused_gallery_ce kernels alone (K1 + K2): "
            f"{alone:.3f} ms")
    for name in rec:
        rec[name]["max_abs_err"] = errs[name]
    return rec


# ---------------------------------------------------------------------------
# phase 3: the image-client slice at full width
# ---------------------------------------------------------------------------

def synth_images(seed: int, row0: int, bs: int, size: int, dev):
    """Public or task images for rows row0 .. row0+bs, made on the device
    from (seed, row0)."""
    gen = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + row0)
    return torch.rand(bs, size, size, 3, generator=gen, device=dev)


def slice_phase(seed: int, dev=torch.device("cuda")):
    import types

    from creamfl_tpu_torch.engine.client_uni import UniClientEngine
    from creamfl_tpu_torch.federation.aggregation import aggregate_modalities
    from creamfl_tpu_torch.ops.l2norm import l2_normalize
    from creamfl_tpu_torch.utils.profiling import StepTimer

    gen = torch.Generator(device=dev).manual_seed(seed)
    global_img = l2_normalize(torch.randn(N_PUB, DIM, generator=gen,
                                          device=dev))
    global_txt = l2_normalize(torch.randn(N_PUB, DIM, generator=gen,
                                          device=dev))
    globals_base = {"same": global_img, "other": global_txt}
    args = types.SimpleNamespace(img_model_local="resnet18",
                                 feature_dim=DIM, mlp_local=False,
                                 interintra_weight=0.5, loss_scale=False)
    engine = UniClientEngine("img", num_class=N_CLASS, args=args,
                             device=dev)
    timer = StepTimer(device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reps = []
    for k in range(N_CLIENTS):
        state = engine.set_round_lr(engine.init_state(seed + k), 0)
        old = engine.snapshot(state)
        for step in range(TASK_STEPS):
            images = synth_images(seed + 100 * k, step * TASK_BS, TASK_BS,
                                  32, dev)
            labels = torch.randint(0, N_CLASS, (TASK_BS,), generator=gen,
                                   device=dev)
            with timer.phase("task_step"):
                state, metrics = engine.task_step(
                    state, {"images": images, "labels": labels})
        losses = [float(metrics["loss"])]
        rows = [(s * PUB_BS, PUB_BS) for s in range(CONTRAST_STEPS)]
        rows.append((N_PUB - TAIL_BS, TAIL_BS))  # the ragged last batch
        for row0, bs in rows:
            batch = {"images": synth_images(seed, row0, bs, 224, dev)}
            globals_ = dict(globals_base, index=torch.arange(
                row0, row0 + bs, device=dev))
            with timer.phase("contrast_step"):
                state, loss = engine.contrast_step(state, old, batch,
                                                   globals_, True, True)
            losses.append(float(loss))
        test = {"images": synth_images(seed + 7, 0, TASK_BS, 32, dev),
                "labels": torch.randint(0, N_CLASS, (TASK_BS,),
                                        generator=gen, device=dev)}
        with timer.phase("test_step"):
            c1, ck, cnt = (float(x) for x in engine.test_step(state, test))
        feats = torch.empty(N_PUB, DIM, device=dev)
        with timer.phase("features_sweep"):
            for row0 in range(0, N_PUB, PUB_BS):
                bs = min(PUB_BS, N_PUB - row0)
                out, _ = engine.features_step(
                    state, {"images": synth_images(seed, row0, bs, 224,
                                                   dev)})
                feats[row0:row0 + bs] = out
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"client {k}: non-finite losses {losses}")
        if not bool(torch.isfinite(feats).all()):
            raise AssertionError(f"client {k}: non-finite features")
        norms = feats.norm(dim=1)
        if not bool(((norms - 1).abs() < 1e-4).all()):
            raise AssertionError(f"client {k}: features are not unit rows")
        log(f"[slice] client {k}: losses {[round(x, 5) for x in losses]} "
            f"test top1 {c1}/{cnt} topk {ck}/{cnt}")
        reps.append(feats)
    img_reps = torch.stack(reps)
    del reps
    with timer.phase("con_w"):
        img_agg, txt_agg = aggregate_modalities(img_reps, None, global_img,
                                                global_txt)
    if txt_agg is not None or img_agg.shape != (N_PUB, DIM):
        raise AssertionError("aggregate has the wrong shape")
    if not bool(torch.isfinite(img_agg).all()):
        raise AssertionError("non-finite aggregate")
    # The aggregate is a convex combination of the client reps, row by row.
    lo, hi = img_reps.min(dim=0).values, img_reps.max(dim=0).values
    if not bool(((img_agg >= lo - 1e-5) & (img_agg <= hi + 1e-5)).all()):
        raise AssertionError("aggregate outside the clients' hull")
    # Agreement with con_w computed from the plain diagonal.
    from creamfl_tpu_torch.ops.gallery import gallery_log_softmax_diag

    alpha = torch.softmax(torch.stack([
        gallery_log_softmax_diag(r, global_txt) for r in img_reps]), dim=0)
    ref = torch.einsum("kn,knd->nd", alpha, img_reps)
    check("con_w aggregate vs plain", img_agg, ref,
          dict(rtol=0.0, atol=1e-5))
    log(f"[slice] phases {json.dumps(timer.report())}")
    if dev.type == "cuda":
        log(f"[slice] peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from creamfl_tpu_torch.ops import gallery_kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    build_phase()
    rec = kernel_phase(opts.seed)
    K.reset_launch_counts()
    slice_phase(opts.seed)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    log(f"[slice] kernels {json.dumps(counts)}")
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], launches=counts[name],
                    **rec[name])
               for name in REPLACES]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
