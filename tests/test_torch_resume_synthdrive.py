"""The resume watcher (ssdx_torch/tools/resume_synthdrive.py) on the CPU.

The watcher runs a stand-in for ``tools/train_synthdrive.py`` that prints the
tool's ``Epoch:`` lines and saves ``{workdir}/ckpt/last.ckpt`` as
``train.checkpoint`` does (a pickle whose ``epoch`` is the last completed
one), and resumes from it on a rerun.  The watcher must kill it with SIGKILL
once the checkpoint holds one epoch of two, while the second trains, then
rerun the same command, which trains only the second epoch.  (The tool's own
resume is tested by tests/test_torch_tools_train.py.)
"""
import sys

import pytest

from ssdx_torch.tools import resume_synthdrive

STAND_IN = '''
import argparse, os, pickle, sys, time
from pathlib import Path
ap = argparse.ArgumentParser()
ap.add_argument("--workdir")
ap.add_argument("--epochs", type=int)
a = ap.parse_args()
last = Path(a.workdir) / "ckpt" / "last.ckpt"
last.parent.mkdir(parents=True, exist_ok=True)
start = 0
if last.exists():
    start = pickle.loads(last.read_bytes())["epoch"] + 1
    print(f"resumed from {last}: {start} epochs done, {a.epochs - start} of {a.epochs} remaining")
for epoch in range(start, a.epochs):
    time.sleep(1.0)  # the epoch's steps
    print(f"Epoch: {epoch}  |  mAP: 0.5", flush=True)
    time.sleep(0.3)  # eval and the checkpoint follow the line
    tmp = last.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps({"epoch": epoch}))
    os.replace(tmp, last)
print("done", flush=True)
'''


def test_kill_once_the_checkpoint_holds_one_epoch_then_resume(tmp_path, capfd, monkeypatch):
    tool = tmp_path / "stand_in.py"
    tool.write_text(STAND_IN)
    monkeypatch.setattr(resume_synthdrive, "GRACE_S", 0.0)
    monkeypatch.setattr(resume_synthdrive, "_command",
                        lambda args: [sys.executable, "-u", str(tool), *args])
    wd = tmp_path / "sd"
    rc = resume_synthdrive.main(["--kill-after", "1", "--",
                                 "--workdir", str(wd), "--epochs", "2"])
    out = capfd.readouterr().out
    assert rc == 0, out
    lines = out.splitlines()
    assert lines == [
        "Epoch: 0  |  mAP: 0.5",
        "killed with SIGKILL (rc -9); last.ckpt holds 1 epochs",
        f"resumed from {wd / 'ckpt' / 'last.ckpt'}: 1 epochs done, 1 of 2 remaining",
        "Epoch: 1  |  mAP: 0.5",
        "done",
    ], out


def test_kill_each_resumed_run_in_turn(tmp_path, capfd, monkeypatch):
    tool = tmp_path / "stand_in.py"
    tool.write_text(STAND_IN)
    monkeypatch.setattr(resume_synthdrive, "GRACE_S", 0.0)
    monkeypatch.setattr(resume_synthdrive, "_command",
                        lambda args: [sys.executable, "-u", str(tool), *args])
    wd = tmp_path / "sd"
    rc = resume_synthdrive.main(["--kill-after", "1", "2", "--",
                                 "--workdir", str(wd), "--epochs", "3"])
    out = capfd.readouterr().out
    assert rc == 0, out
    last = wd / "ckpt" / "last.ckpt"
    assert out.splitlines() == [
        "Epoch: 0  |  mAP: 0.5",
        "killed with SIGKILL (rc -9); last.ckpt holds 1 epochs",
        f"resumed from {last}: 1 epochs done, 2 of 3 remaining",
        "Epoch: 1  |  mAP: 0.5",
        "killed with SIGKILL (rc -9); last.ckpt holds 2 epochs",
        f"resumed from {last}: 2 epochs done, 1 of 3 remaining",
        "Epoch: 2  |  mAP: 0.5",
        "done",
    ], out


@pytest.mark.parametrize("kills", [["2", "1"], ["0"], ["3", "3"]])
def test_kill_points_must_increase_from_one(kills, tmp_path):
    with pytest.raises(SystemExit):
        resume_synthdrive.main(["--kill-after", *kills, "--", "--workdir", str(tmp_path)])
