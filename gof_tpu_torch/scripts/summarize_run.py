"""Summarize a training run's train_log.jsonl into the validation report
(python -m gof_tpu_torch.scripts.summarize_run <model_dir>; counterpart of
scripts/summarize_run.py): iteration-rate trajectory, PSNR milestones,
point and key growth, eval results."""
import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model_dir")
    args = ap.parse_args(argv)
    path = os.path.join(args.model_dir, "train_log.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "loss" in r]
    evals = [r for r in rows if "eval" in r]

    print(f"run: {args.model_dir}")
    print(f"iterations logged: {steps[-1]['iter']}  wall: {steps[-1]['elapsed']:.0f}s")
    print(f"final points: {steps[-1]['points']}  final keys: {steps[-1]['keys']}")
    peak_pts = max(r["points"] for r in steps)
    peak_keys = max(r["keys"] for r in steps)
    print(f"peak points: {peak_pts}  peak keys: {peak_keys}")

    print("\nphase rates (it/s over 1k-iter windows):")
    last = None
    for r in steps:
        if r["iter"] % 1000 == 0:
            if last is not None and r["elapsed"] > last["elapsed"]:
                rate = (r["iter"] - last["iter"]) / (r["elapsed"] - last["elapsed"])
                print(f"  {last['iter']:>6}-{r['iter']:>6}: {rate:5.2f} it/s  "
                      f"(points {r['points']}, keys {r['keys']}, psnr {r['psnr']:.2f})")
            last = r

    print("\nevals:")
    for e in evals:
        print(f"  iter {e['iter']:>6}: PSNR {e['eval']['psnr']:.3f} over "
              f"{e['eval']['views']} views")


if __name__ == "__main__":
    main()
