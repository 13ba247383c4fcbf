"""The port's fleet launcher (``repro_torch.launch.launcher``): the
reference's two tests (tests/test_launcher.py) with ``--device cpu``, and
``fleet_init`` with and without the scheduler's environment."""
import os
import socket
import subprocess
import sys

import pytest

from repro_torch.launch import launcher

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FLEET_ENV = ("COORDINATOR_ADDRESS", "PROCESS_COUNT", "PROCESS_ID")


def _run(args, extra_env=None, code=None, timeout=560):
    env = {k: v for k, v in os.environ.items() if k not in _FLEET_ENV}
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    env.update(extra_env or {})
    cmd = ["-c", code] if code else ["-m", "repro_torch.launch.launcher"]
    return subprocess.run([sys.executable] + cmd + args, capture_output=True,
                          text=True, env=env, timeout=timeout)


def test_validate_gate_full_config():
    """--validate runs the dry run of the full-scale arch on meta tensors
    (no devices needed, where the reference lowers for its 512-device mesh):
    the unsharded step, then the tensor-parallel step as one rank of the
    fake 2 x 16 x 16 group runs it, its collectives and peak a device."""
    out = _run(["--arch", "qwen2_vl_2b", "--validate", "--multi-pod",
                "--device", "cpu"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "validate OK" in out.stdout and "one device, unsharded" in out.stdout
    assert "qwen2-vl-2b " in out.stdout          # the full config, not reduced
    tp = [l for l in out.stdout.splitlines()
          if "tensor-parallel on 2x16x16: collective wire bytes/dev" in l]
    assert len(tp) == 1 and "all_reduce" in tp[0] and "all_gather" in tp[0]
    assert "peak/dev" in tp[0]


def test_local_smoke_train():
    """Without a mesh the launcher reduces the config and trains."""
    out = _run(["--arch", "stablelm_12b", "--steps", "4", "--seq-len", "32",
                "--global-batch", "4", "--opt", "zero1", "--device", "cpu"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "loss" in out.stdout and "stablelm-12b-reduced" in out.stdout


def test_train_saves_and_resumes(tmp_path):
    """Step 49 is saved on rank 0; a second launch resumes after it (its
    first logged step is 50) with the flash route and chunked loss."""
    args = ["--arch", "phi3_medium_14b", "--seq-len", "16",
            "--global-batch", "2", "--opt", "flash,losschunk,mb:2",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    out = _run(args + ["--steps", "50"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert os.path.isdir(tmp_path / "step_000000049")
    assert "'attn': 'flash'" in out.stdout and "mb=2" in out.stdout
    out = _run(args + ["--steps", "51"])
    assert out.returncode == 0, out.stdout + out.stderr
    logged = [line.split()[1] for line in out.stdout.splitlines()
              if line.strip().startswith("step ")]
    assert logged == ["50"]


def test_parse_opt_as_the_reference():
    step_kw, hp_kw, shown = launcher.parse_opt("seq,losschunk,zero1,mb:4,moe")
    assert step_kw == {"attn": "plain", "loss_chunk": 512}
    assert hp_kw == {"zero1": True, "microbatch": 4}
    assert shown["seq_shard"] and shown["shardmap_moe"]
    step_kw, hp_kw, _ = launcher.parse_opt("flash")
    assert step_kw == {"attn": "flash", "loss_chunk": None}
    assert hp_kw == {"zero1": False, "microbatch": 1}


def test_fleet_init_single_host(monkeypatch):
    for k in _FLEET_ENV:
        monkeypatch.delenv(k, raising=False)
    assert launcher.fleet_init("cpu") == (0, 1)
    import torch.distributed as dist
    assert not dist.is_initialized()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_fleet_init_from_the_scheduler_env():
    """With the scheduler's variables set it joins a gloo group on the CPU
    over tcp://COORDINATOR_ADDRESS (one process here)."""
    code = ("import torch.distributed as dist\n"
            "from repro_torch.launch.launcher import fleet_init\n"
            "print(fleet_init('cpu'), dist.get_backend())\n"
            "dist.destroy_process_group()\n")
    out = _run([], extra_env={"COORDINATOR_ADDRESS": f"localhost:{_free_port()}",
                              "PROCESS_COUNT": "1", "PROCESS_ID": "0"},
               code=code, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split() == ["(0,", "1)", "gloo"]


def test_more_than_one_process_is_refused(monkeypatch, capsys):
    """More than one process trains data-parallel
    (tests/test_torch_dp_train.py), the MoE family too: under ``--opt moe``
    with the shard-mapped dispatch and, since slice 19, without it, one
    dispatch over the global batch (it was refused before). The same call
    now runs (an abstract mesh: no process group, each rank's own rows)."""
    from repro_torch.launch import mesh
    monkeypatch.setattr(launcher, "fleet_init",
                        lambda device, backend=None: (0, 2))
    monkeypatch.setattr(mesh, "make_host_mesh",
                        lambda model=1, device=None: mesh.AbstractMesh(
                            (2, model), ("data", "model"), device))
    assert launcher.launch_train("moonshot_v1_16b_a3b", multi_pod=False,
                                 opt="zero1", steps=1, seq_len=8,
                                 global_batch=2, ckpt_dir=None,
                                 validate_only=False, device="cpu") == 0
    out = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 1}" in out and "step 0 loss" in out