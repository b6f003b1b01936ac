"""SIGTERM during training: ``cli train`` and ``cli train-image`` (each a
subprocess on the CPU, tiny model) write a checkpoint at the step they are
at and exit 0 (``GracefulShutdown``, as the JAX trainers do); a second run
resumes from that checkpoint. On a mesh, a signal that reaches one rank
stops every rank at the same step."""
import os
import re
import signal
import subprocess
import sys

from test_torch_image_training import _train_argv
from test_torch_training import _write_videos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _interrupt_then_resume(argv, ckpt_dir):
    """Run ``argv`` (with --max_steps 200), send SIGTERM once its third
    step is logged, and check the checkpoint it leaves; then run it to one
    step past that checkpoint and check that it resumed there."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable, "-m", "video_gpt_tpu_torch.cli", *argv]
    proc = subprocess.Popen(cmd + ["--max_steps", "200"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("step 3:"):
                proc.send_signal(signal.SIGTERM)
                break
        lines += proc.stdout.readlines()
        assert proc.wait(timeout=120) == 0, "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines)
    m = re.search(r"shutdown requested: checkpoint-(\d+) durable", out)
    assert m, out
    step = int(m.group(1))
    assert 3 <= step < 200 and f"step {step + 1}:" not in out
    assert os.path.exists(os.path.join(ckpt_dir, str(step), "state.pt"))
    res = subprocess.run(cmd + ["--max_steps", str(step + 1)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"resumed from step {step}" in res.stdout
    assert f"step {step + 1}:" in res.stdout


def test_sigterm_checkpoints_train_and_resumes(tmp_path):
    videos = str(tmp_path / "videos")
    _write_videos(videos)
    run = tmp_path / "run"
    _interrupt_then_resume(
        ["train", "--device", "cpu", "--tiny_model", "--video_dir_path",
         videos, "--results_dir", str(run), "--frame_num", "4",
         "--target_resolution", "48", "64", "--mixed_precision", "no",
         "--lr_scheduler", "constant", "--log_every", "1",
         "--ckpt_every", "1000"], str(run / "checkpoints"))


def test_sigterm_checkpoints_train_image_and_resumes(tmp_path):
    _interrupt_then_resume(_train_argv(tmp_path, "--ckpt_every", "1000"),
                           str(tmp_path / "run" / "checkpoints"))


def test_sigterm_to_one_rank_checkpoints_every_rank(tmp_path):
    """A (data 2) run in which one rank alone receives SIGTERM: the ranks
    agree on the flag each step (``GracefulShutdown.agreed``), so every
    rank stops and writes its part at the same step, and none waits in a
    collective that the other never issues."""
    import torch_mesh_ranks as ranks
    from video_gpt_tpu_torch.config import MeshConfig
    from video_gpt_tpu_torch.parallel.distributed import spawn_ranks
    videos = str(tmp_path / "videos")
    _write_videos(videos)
    run, rdzv = tmp_path / "run", tmp_path / "rdzv"
    rdzv.mkdir()
    res = spawn_ranks(ranks.sigterm_run,
                      (videos, str(run), MeshConfig(data=2), 2), 2,
                      str(rdzv), threads=1, timeout=300)
    assert [r["step"] for r in res] == [2, 2]
    assert sorted(os.listdir(run / "checkpoints" / "2")) == [
        "mesh.json", "rank0.pt", "rank1.pt"]
