"""Side-by-side measurements of the fp32 attention kernels on the card.

Run from the root of the tree to measure (its ``chip_smoke.py`` and
package are imported from the current directory), with one CUDA device:

    python <repo>/tools/fp32_ab.py rows LABEL [fwd] [k3train] [bwd] [bf16]
    python <repo>/tools/fp32_ab.py e2e LABEL
    python <repo>/tools/fp32_ab.py ablate [VARIANT ...]

``rows``: the fp32 kernel rows of the smoke's kernels phase (``fwd``: K1,
K2, K3 at the flagship and the image decode, K3 at stage 1, K6 at the
batched prefill; ``k3train``: K3 at stage 1 alone; ``bwd``: K9 at stage 1,
K7 at a seq-2 rank and a ring hop) and ``bf16``: the bf16 K1 flagship and
K9 stage-1 rows, each checked against its plain version at its bar and
timed (not the plain version or SDPA); one JSON line a row. ``e2e``: the
fp32 clip and three 2-step fp32 images (the first a warm-up) at full
depth. ``ablate``: the fp32 kernels rebuilt from a copy of ``csrc/`` with
one part removed (results wrong by design) and timed at K1 / K2 / K3 (fp32,
stage 1) / K9 (fp32, stage 1); the variants' edits name lines of the
sources they were written against and fail loudly where those moved.

To compare two trees on one card, run the same command in each tree's
root within one call, in the order parent, change, change, parent.
"""
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from video_gpt_tpu_torch.ops import _cuda  # noqa: E402
from video_gpt_tpu_torch.ops.attention import AttnMeta  # noqa: E402

F, B, S = "fp32_attention.cu", "fp32_attention_bwd.cu", "fp32_split.cuh"
# (file, the text as written, its replacement)
VARIANTS = {
    "base": [],
    "one_product": [(S, "constexpr int kSplitProducts = 6;",
                     "constexpr int kSplitProducts = 1;")],
    "no_exp": [
        (F, "        float x = exp2f(fminf(fmaxf(s[j] * a.kscale, -100.f), "
            "100.f));",
         "        float x = fminf(fmaxf(s[j] * a.kscale, -100.f), 100.f);"),
        (B, "        x[j] = ok ? exp2f((xs - xr) - off) : 0.f;",
         "        x[j] = ok ? (xs - xr) - off : 0.f;"),
        (B, "      const float p = ok ? exp2f((x - xr[hi]) - off[hi]) : 0.f;",
         "      const float p = ok ? (x - xr[hi]) - off[hi] : 0.f;")],
}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def rows(label: str, want) -> None:
    dev = torch.device("cuda")
    t = time.time()
    _cuda.libraries()
    emit(tree=label, build_s=time.time() - t)

    def skip_timing(fn):
        # the kernel alone is timed: the plain version and SDPA are not
        def wrapped(*a, **k):
            return fn(*a, **k)
        wrapped.skip = True
        return wrapped

    timed = cs.timed
    cs.timed = (lambda fn, max_reps, budget_ms=cs.TIME_BUDGET_MS:
                float("nan") if getattr(fn, "skip", False)
                else timed(fn, max_reps, budget_ms))
    check = cs.check_and_time

    def check_and_time(name, r, lbl=""):
        r = dict(r, plain=skip_timing(r["plain"]), lib=skip_timing(r["lib"]))
        rec = check(name, r, lbl)
        emit(tree=label, row=name + lbl,
             **{k: rec.get(k) for k in ("ms", "err_over_bar", "max_abs_err",
                                        "bound_ms")})
        return rec

    cs.check_and_time = check_and_time
    cs.WIDTHS = ()
    cs.BWD_WIDTHS = (("fp32", torch.float32, 96),)
    cs.RING_HOP_WIDTHS = (96,)
    meta1 = AttnMeta(*(x.to(dev) for x in
                       cs.train_batch(1).inputs.batch.meta))
    if "fwd" in want:
        for _ in cs.width_kernels(dev):
            torch.cuda.empty_cache()
    if "k3train" in want:
        check_and_time("K3", cs.bias_record(dev, 69, meta1, 133,
                                            dtype=torch.float32),
                       " (fp32_train)")
        torch.cuda.empty_cache()
    if "bwd" in want:
        for _ in cs.width_bwd_kernels(dev):
            torch.cuda.empty_cache()
    if "bf16" in want:
        n_img = cs.tokens_per_frame(cs.H_PX, cs.W_PX)
        lay = cs.frame_block_inference_layout(cs.N_CLEAN, cs.N_GEN, n_img,
                                              False)
        check_and_time("K1", cs.decode_split_record(
            dev, 0, AttnMeta.from_layout(lay, dev), lay.noisy_tail_len(),
            661), " (bf16 flagship)")
        torch.cuda.empty_cache()
        check_and_time("K9", cs.k9_width_record(dev, meta1, 96,
                                                torch.bfloat16, 70),
                       " (bf16 train)")


def e2e(label: str) -> None:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    images = [cs.fp32_image_phase(dev, smi)["image_s"] for _ in range(3)]
    gc.collect()
    torch.cuda.empty_cache()
    clip = cs.fp32_clip_phase(dev, smi)
    emit(tree=label, fp32_image_s=images, fp32_clip_s=clip["clip_s"],
         device=smi)


def ablate(names) -> None:
    dev = torch.device("cuda")
    n_img = cs.tokens_per_frame(cs.H_PX, cs.W_PX)
    lay_c = cs.frame_block_inference_layout(cs.N_CLEAN, cs.N_GEN, n_img,
                                            False)
    lay_u = cs.frame_block_inference_layout(0, cs.N_GEN, n_img, False)
    meta1 = AttnMeta(*(x.to(dev) for x in
                       cs.train_batch(1).inputs.batch.meta))
    f32 = torch.float32
    records = {
        "K1": cs.decode_split_record(dev, 64, AttnMeta.from_layout(
            lay_c, dev), lay_c.noisy_tail_len(), 661, dtype=f32),
        "K2": cs.decode_record(dev, 65, AttnMeta.from_layout(lay_u, dev),
                               416, dtype=f32),
        "K3train": cs.bias_record(dev, 69, meta1, 133, dtype=f32),
        "K9train": cs.k9_width_record(dev, meta1, 96, f32, 70)}
    for name in names or VARIANTS:
        tmp = tempfile.mkdtemp()
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(_cuda.CSRC, csrc)
        for fname, old, new in VARIANTS[name]:
            path = os.path.join(csrc, fname)
            with open(path) as f:
                src = f.read()
            if src.count(old) != 1:
                raise SystemExit(f"{name}: {fname} no longer holds {old!r}")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
        libs = _cuda.build(csrc, os.path.join(tmp, "_build"))
        _cuda.libraries = lambda libs=libs: libs
        emit(variant=name, **{k: cs.timed(r["fn"], max_reps=20,
                                          budget_ms=1000)
                              for k, r in records.items()})
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    mode, *args = sys.argv[1:]
    if mode == "rows":
        rows(args[0], set(args[1:]) or {"fwd", "k3train", "bwd", "bf16"})
    elif mode == "e2e":
        e2e(args[0])
    elif mode == "ablate":
        ablate(args)
    else:
        raise SystemExit(f"unknown mode {mode}: rows, e2e or ablate")
