"""Phases 2-8 and the timing phases of a checkout's chip_smoke.py on a card.

    python3 chip_ab.py [CHECKOUT] [--json OUT]

Runs CHECKOUT's own `chip_smoke.py` functions with CHECKOUT's own package
(default: the directory of this script): device and build (phases 0, 1),
the kernel checks (2), a sha256 of each output of K1, K2, K5, K6 and K7 at
head width 64 (the main path's inputs at B = 8 and B = 1 and K6 / K7 as K2
runs them, with bf16 and with f32 products: equal hashes on two trees are
the same bits), c16_r50's evaluate, train epoch and train steps against
the CPU (3), survival (6), FFN (7), unmasked, brca_r50 and the canonical
configs (8), then the kernel times (4: each kernel at a 9000-patch bag's
shapes, B = 8 and B = 1, K2's products, K5-K7 against their library
calls), the forward, train, `--amp`, survival and FFN throughputs, and
c16_r50's train step at B = 1 and 8 over 50 steps.  Two trees are compared in one call by running it on each in
turn, parent, change, change, parent: only functions both trees have are
called.  Writes the phases' return values as JSON to OUT (default
`chiprun_out/chip_ab.json` in CHECKOUT) and exits non-zero if a phase fails
or no card is present.
"""
import hashlib
import json
import os
import sys
import time

HASHED = ("K1", "K2", "K5", "K6", "K7")


def output_hashes(c, dev):
    """{case: [sha256 of each output]} of K1, K2, K5, K6 and K7 at head
    width 64 on `c` (a checkout's chip_smoke module): its kernel_cases at
    B = 8 and B = 1 and extra_cases, bf16 and f32 products."""
    import torch
    out = {}
    for mm in (torch.bfloat16, torch.float32):
        groups = [(f"B={b}", c.kernel_cases(b, dev, torch.float32))
                  for b in (8, 1)] + [("extra",
                                       c.extra_cases(dev, torch.float32))]
        for tag, cases in groups:
            for name, (fn, _, args) in cases.items():
                if not name.startswith(HASHED):
                    continue
                res = fn(*args, mm_dtype=mm)
                res = res if isinstance(res, tuple) else (res,)
                torch.cuda.synchronize()
                out[f"{name} {tag} {c.dname(mm)}"] = [
                    None if t is None else hashlib.sha256(
                        t.detach().contiguous().cpu().numpy().tobytes())
                    .hexdigest()[:16] for t in res]
            del cases
            torch.cuda.empty_cache()
    return out


def train_steps(c, dev):
    """c16_r50's train step ms (c.train_setup: forward, backward, Adam; a
    9000-patch bag, dropout on) at B = 1 and 8 over 50 steps after 10,
    CUDA events: the batch-1 step is host-bound, so more steps than the
    throughput phase's 5 for a comparison of two trees."""
    import torch
    out = {}
    for b in (1, 8):
        eng, step, _ = c.train_setup(dev, b)
        out[str(b)] = c.time_ms(step, iters=50, warmup=10)
        print(f"train step B={b}: {out[str(b)]:.3f} ms", flush=True)
        del eng, step
        torch.cuda.empty_cache()
    return out


def main() -> None:
    args = [a for a in sys.argv[1:]]
    out = None
    if "--json" in args:
        i = args.index("--json")
        out = os.path.abspath(args[i + 1])
        del args[i:i + 2]
    root = os.path.abspath(args[0] if args else os.path.dirname(
        os.path.abspath(__file__)))
    out = out or os.path.join(root, "chiprun_out", "chip_ab.json")
    os.chdir(root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", flush=True)
        sys.exit(2)
    import chip_smoke as c

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    rep = {"root": root, "nvidia_smi": c.phase_device(),
           "build_s": c.phase_build()}
    c.phase_kernels(dev)
    rep["hashes"] = output_hashes(c, dev)
    for case, digests in rep["hashes"].items():
        print(f"hash {case}: {' '.join(str(d) for d in digests)}",
              flush=True)
    for name, fn in (("main_path", c.phase_main_path),
                     ("train", c.phase_train),
                     ("train_vs_cpu", c.phase_train_vs_cpu),
                     ("survival", c.phase_survival),
                     ("survival_vs_cpu", c.phase_survival_vs_cpu),
                     ("ffn", c.phase_ffn), ("unmasked", c.phase_unmasked),
                     ("brca", c.phase_brca),
                     ("canonical", c.phase_canonical)):
        rep[name] = fn(dev)
    rep["times"] = c.phase_times_products(dev, c.phase_times_pairs(
        dev, c.phase_times_slice3(dev, c.phase_times(dev))))
    for name in ("throughput", "train_throughput", "amp_throughput",
                 "survival_throughput", "ffn_throughput"):
        rep[name] = getattr(c, f"phase_{name}")(dev)
    rep["train_steps"] = train_steps(c, dev)
    rep["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rep, f, default=str)
    print(rep["nvidia_smi"], flush=True)
    print(f"chip_ab: {root} in {rep['seconds']:.1f} s", flush=True)


if __name__ == "__main__":
    main()
