"""Kill a SynthDrive run after a number of epochs, then resume it.

    python -m ssdx_torch.tools.resume_synthdrive --kill-after 15 [16 17 ...] -- \\
        --workdir DIR --n-train 5000 --n-test 1000 --epochs 20 --batch-size 16

Runs ``python -m ssdx_torch.tools.train_synthdrive`` with the arguments after
``--``, reads its ``Epoch:`` lines, and once ``{workdir}/ckpt/last.ckpt``
holds ``--kill-after`` completed epochs (10 s after that save, into the next epoch),
ends the process with SIGKILL, as an out-of-memory kill would.  Then it runs
the same command again, which resumes from ``last.ckpt``; given several
counts, it kills each resumed run in turn at the next count, so that every
epoch after the first kill starts a fresh process (whose loaders replay
epoch 0's permutation and augmentation draws).  It exits with the code of
the last run, which it lets finish.  The tool itself has no flag for this:
the kill comes from outside, as it did to the JAX package's SynthDrive run
(killed at its fifteenth epoch and resumed in fresh processes).
"""
from __future__ import annotations

import argparse
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["main"]

GRACE_S = 10.0  # between the checkpoint and the kill: the next epoch has begun


def _command(tool_args: list[str]) -> list[str]:
    return [sys.executable, "-u", "-m", "ssdx_torch.tools.train_synthdrive", *tool_args]


def _workdir(tool_args: list[str]) -> Path:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workdir", required=True)
    return Path(ap.parse_known_args(tool_args)[0].workdir)


def _epochs_done(ckpt: Path) -> int:
    with open(ckpt, "rb") as f:
        return int(pickle.load(f)["epoch"]) + 1  # a file this package wrote


def _kill_at(tool_args: list[str], last: Path, kill_after: int, env: dict) -> None:
    """Run the tool until ``last`` holds ``kill_after`` epochs, then SIGKILL it."""
    proc = subprocess.Popen(_command(tool_args), stdout=subprocess.PIPE, text=True, env=env)
    mark = None
    try:
        for line in proc.stdout:
            print(line, end="", flush=True)
            if line.startswith(f"Epoch: {kill_after - 1} "):  # epochs count from 0
                mark = last.stat().st_mtime if last.exists() else 0.0
                break
        if mark is None:
            raise SystemExit(f"the run ended before epoch {kill_after - 1}, before the kill")
        while not last.exists() or last.stat().st_mtime <= mark:  # the save follows the line
            if proc.poll() is not None:
                raise SystemExit("the run ended before it saved the checkpoint")
            time.sleep(0.2)
        time.sleep(GRACE_S)
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    done = _epochs_done(last)
    print(f"killed with SIGKILL (rc {proc.returncode}); last.ckpt holds {done} epochs",
          flush=True)
    if done != kill_after:
        raise SystemExit(f"last.ckpt holds {done} epochs, not {kill_after}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kill-after", type=int, nargs="+", required=True,
                    help="completed epochs in last.ckpt at each kill, increasing")
    ap.add_argument("tool_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.kill_after != sorted(set(args.kill_after)) or args.kill_after[0] < 1:
        ap.error("--kill-after takes increasing epoch counts >= 1")
    tool_args = [a for a in args.tool_args if a != "--"]
    last = _workdir(tool_args) / "ckpt" / "last.ckpt"
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    for k in args.kill_after:
        _kill_at(tool_args, last, k, env)
    return subprocess.run(_command(tool_args), env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
