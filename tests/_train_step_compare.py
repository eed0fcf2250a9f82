"""GPT-2 small's Sophia-G training step on the card, this checkout against
another one (the parent commit), in turns (old, new, new, old), each turn
a process of its own.  A diagnostic behind PERF.md, not a test (pytest
does not collect it); it needs an NVIDIA GPU and nvcc.  Unpack the other
commit into the ignored ``build/`` first:

    mkdir -p build/parent
    git archive 7188079 | tar -x -C build/parent
    python3 tests/_train_step_compare.py build/parent [--out FILE.json]

Each turn builds the kernels of its checkout (into that checkout's
``build/``), then runs ``chip_smoke.py`` phase 4's protocol: GPT-2 small,
B=8 x S=1024, bf16, Sophia-G with the fused kernels, 12 steps with a
refresh every 5th; the host's clock around each step, synchronised after
it.  Step 0 carries the first-call costs and is left out of both medians.
Printed per side: the plain and refresh steps' times over both of its
turns and their medians, and the plain median's difference, new - old.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(checkout):
    """One turn: the step times of ``checkout``'s trainer, as JSON."""
    sys.path[:0] = [checkout, os.path.join(checkout, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_source
    from repro_torch.train import TrainerConfig
    from repro_torch.train.trainer import to_device_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    cfg = get_config("gpt2-small")
    tc = TrainerConfig(peak_lr=6e-4, total_steps=cs.TRAIN_STEPS,
                       warmup_steps=2, hess_interval=cs.TRAIN_K,
                       hess_subbatch=cs.TRAIN_SUB, seed=0, fused_kernel=True)
    state, train_step = cs._train_fns(torch, cfg, tc, "cuda")
    src = make_source(DataConfig(seq_len=cs.TRAIN_S,
                                 global_batch=cs.TRAIN_B,
                                 vocab_size=cfg.vocab_size, seed=0))
    batches = [to_device_batch(src.batch_at(t), "cuda")
               for t in range(cs.TRAIN_STEPS)]
    torch.cuda.synchronize()
    times, losses = [], []
    for t in range(cs.TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[t], t % cs.TRAIN_K == 0)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    k = cs.TRAIN_K
    print(json.dumps({
        "plain_ms": [x for t, x in enumerate(times) if t % k],
        "refresh_ms": [x for t, x in enumerate(times) if t and t % k == 0],
        "step0_ms": times[0], "losses": losses}))


def turn(checkout):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--child", os.path.abspath(checkout)],
                          capture_output=True, text=True, cwd=checkout)
    if proc.returncode:
        raise RuntimeError(f"turn in {checkout} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("old", help="the other commit's checkout")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    sides = {"old": args.old, "new": ROOT}
    runs = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        t0 = time.perf_counter()
        runs[side].append(turn(sides[side]))
        r = runs[side][-1]
        print(f"[{side}] plain p50 {statistics.median(r['plain_ms']):.2f} "
              f"ms, refresh p50 {statistics.median(r['refresh_ms']):.2f} "
              f"ms, losses {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    report = {"card": card}
    for side, rs in runs.items():
        plain = [x for r in rs for x in r["plain_ms"]]
        refresh = [x for r in rs for x in r["refresh_ms"]]
        report[side] = {"plain_ms": plain, "refresh_ms": refresh,
                        "plain_p50_ms": statistics.median(plain),
                        "refresh_p50_ms": statistics.median(refresh),
                        "losses": [r["losses"] for r in rs]}
    for key in ("plain_p50_ms", "refresh_p50_ms"):
        report[f"{key}_new_minus_old"] = (report["new"][key]
                                          - report["old"][key])
    print(f"{card}: plain p50 old {report['old']['plain_p50_ms']:.2f} ms, "
          f"new {report['new']['plain_p50_ms']:.2f} ms "
          f"({report['plain_p50_ms_new_minus_old']:+.2f}); refresh p50 old "
          f"{report['old']['refresh_p50_ms']:.2f} ms, new "
          f"{report['new']['refresh_p50_ms']:.2f} ms "
          f"({report['refresh_p50_ms_new_minus_old']:+.2f}); each over "
          f"{len(report['new']['plain_ms'])} plain and "
          f"{len(report['new']['refresh_ms'])} refresh steps a side",
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        main()
