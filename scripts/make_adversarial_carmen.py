#!/usr/bin/env python
"""Generate the checked-in ADVERSARIAL CARMEN log (examples/data/
adversarial_180.clf): 180-degree FoV, 20% beam dropout, 3 cm range noise,
systematically drifting odometry with slip events, ground truth embedded as
"# TRUTH" comments (io/datasets.simulate_adversarial_log).

    python scripts/make_adversarial_carmen.py [--out PATH]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples", "data", "adversarial_180.clf"))
    ap.add_argument("--scans", type=int, default=360)
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="cpu")
    args = ap.parse_args()

    from slamnet_tpu.runtime import select_platform, setup_compile_cache
    select_platform(args.platform)
    setup_compile_cache()
    import numpy as np

    from slamnet_tpu.io import datasets

    log = datasets.simulate_adversarial_log(n_scans=args.scans)
    datasets.write_carmen(args.out, log)

    # report the log's difficulty: odometry-only error vs truth
    err = np.linalg.norm(log.odometry[:, :2] - log.truth[:, :2], axis=1)
    drop = 1.0 - log.valid.mean()
    print(f"wrote {args.out}: {log.ranges.shape[0]} scans x "
          f"{log.ranges.shape[1]} beams, {drop:.0%} beams invalid")
    print(f"odometry-only error vs truth: final {err[-1]:.3f} m, "
          f"max {err.max():.3f} m, rms {np.sqrt((err ** 2).mean()):.3f} m")


if __name__ == "__main__":
    main()
