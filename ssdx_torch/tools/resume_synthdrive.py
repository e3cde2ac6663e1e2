"""Kill a SynthDrive run after a number of epochs, then resume it.

    python -m ssdx_torch.tools.resume_synthdrive --kill-after 15 -- \\
        --workdir DIR --n-train 5000 --n-test 1000 --epochs 20 --batch-size 16

Runs ``python -m ssdx_torch.tools.train_synthdrive`` with the arguments after
``--``, counts its ``Epoch:`` lines, and once ``{workdir}/ckpt/last.ckpt``
holds ``--kill-after`` completed epochs (10 s after that save, into the next epoch),
ends the process with SIGKILL, as an out-of-memory kill would.  Then it runs
the same command again, which resumes from ``last.ckpt``, and exits with that
run's code.  The tool itself has no flag for this: the kill comes from
outside, as it did to the JAX package's SynthDrive run (killed at its
fifteenth epoch and resumed).
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kill-after", type=int, required=True,
                    help="completed epochs in last.ckpt before the kill")
    ap.add_argument("tool_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    tool_args = [a for a in args.tool_args if a != "--"]
    last = _workdir(tool_args) / "ckpt" / "last.ckpt"
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}

    proc = subprocess.Popen(_command(tool_args), stdout=subprocess.PIPE, text=True, env=env)
    seen, mark = 0, None
    try:
        for line in proc.stdout:
            print(line, end="", flush=True)
            if line.startswith("Epoch: "):
                seen += 1
                if seen == args.kill_after:
                    mark = last.stat().st_mtime if last.exists() else 0.0
                    break
        if mark is None:
            raise SystemExit(f"the run ended after {seen} epochs, before the kill")
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
    if done != args.kill_after:
        raise SystemExit(f"last.ckpt holds {done} epochs, not {args.kill_after}")
    return subprocess.run(_command(tool_args), env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
