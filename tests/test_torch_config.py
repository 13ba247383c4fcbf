"""The PyTorch port's configs and package boundary.

No numeric tolerance here: config field names and defaults must equal the
JAX reference's exactly, and the port must import neither ``jax`` nor
anything of ``repro``.
"""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.configs import base as jbase
from repro.core.dsst import DSSTConfig as JDSSTConfig
from repro.core.gating import GatingConfig as JGatingConfig
from repro.core.ossl import OSSLConfig as JOSSLConfig
from repro.core.snn import SNNConfig as JSNNConfig
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.launch.train import TrainHParams as JTrainHParams
from repro.optim.optimizer import AdamWConfig as JAdamWConfig
from repro_torch.configs import base
from repro_torch.core import engine
from repro_torch.core.dsst import DSSTConfig
from repro_torch.core.gating import GatingConfig
from repro_torch.core.ossl import OSSLConfig
from repro_torch.core.snn import SNNConfig
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.launch.train import TrainHParams
from repro_torch.optim.optimizer import AdamWConfig

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        else:
            default = "<required>"
        out.append((f.name, _plain(default)))
    return out


@pytest.mark.parametrize("ref,port", [(JSNNConfig, SNNConfig),
                                      (JDSSTConfig, DSSTConfig),
                                      (JGatingConfig, GatingConfig),
                                      (jbase.ModelConfig, base.ModelConfig),
                                      (jbase.SparsityConfig, base.SparsityConfig),
                                      (jbase.ShapeConfig, base.ShapeConfig),
                                      (JOSSLConfig, OSSLConfig),
                                      (JAdamWConfig, AdamWConfig),
                                      (JPipelineConfig, PipelineConfig),
                                      (JTrainHParams, TrainHParams)],
                         ids=["SNNConfig", "DSSTConfig", "GatingConfig",
                              "ModelConfig", "SparsityConfig", "ShapeConfig",
                              "OSSLConfig", "AdamWConfig", "PipelineConfig",
                              "TrainHParams"])
def test_config_fields_and_defaults_match_reference(ref, port):
    assert _fields(port) == _fields(ref)


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert base.SHAPES["train_4k"].tokens == jbase.SHAPES["train_4k"].tokens
    assert base.SparsityConfig().density == jbase.SparsityConfig().density


@pytest.mark.parametrize("fan_in,sparsity,dense", [(512, 0.8, False),
                                                   (16, 0.8, False),
                                                   (64, 0.5, True)])
def test_spec_matches_reference(fan_in, sparsity, dense):
    kw = dict(n_in=fan_in, n_hidden=fan_in, sparsity=sparsity, dense=dense)
    assert dataclasses.asdict(SNNConfig(**kw).spec(fan_in)) == \
        dataclasses.asdict(JSNNConfig(**kw).spec(fan_in))


def test_backend_names():
    assert engine.make_backend(SNNConfig()).name == "ref"
    assert engine.make_backend(SNNConfig(backend="kernels")).use_kernels
    with pytest.raises(ValueError):
        engine.make_backend(SNNConfig(backend="pallas"))


def test_importing_every_port_module_pulls_in_no_jax_and_no_repro():
    """Every module of the package, and every demo of ``examples/torch``
    (imported by path: its ``main`` does not run)."""
    code = (
        "import glob, importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"demos = sorted(glob.glob({str(ROOT / 'examples' / 'torch')!r}"
        " + '/*.py'))\n"
        "for path in demos:\n"
        "    spec = importlib.util.spec_from_file_location('demo', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(names), len(demos))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, n_demos = map(int, out.stdout.split())
    assert n_modules >= 75      # every module was imported
    assert n_demos == 7         # the reference's seven demos, on the port


@pytest.mark.parametrize("module", ["serving.ingest", "serving.autopilot",
                                    "obs.export", "launch.mesh",
                                    "launch.sharding"])
def test_runtime_modules_alone_pull_in_no_jax_and_no_repro(module):
    """The serving runtime's host-side modules and the slot mesh and its
    rules, each imported alone in a fresh interpreter."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('repro_torch.{module}')\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr


def test_ingest_worker_module_uses_no_torch():
    """The ingest worker thread competes with the host enqueue for the
    interpreter lock and must never touch a tensor: its module imports
    nothing but the standard library."""
    tree = ast.parse((PORT / "serving" / "ingest.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import reaches the package"
            imported.add((node.module or "").split(".")[0])
    assert imported <= {"__future__", "dataclasses", "threading",
                        "collections", "typing"}, imported


def test_no_source_file_imports_repro_or_jax():
    offenders = []
    demos = sorted((ROOT / "examples" / "torch").glob("*.py"))
    assert len(demos) == 7
    for path in sorted(PORT.rglob("*.py")) + demos:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("repro", "jax", "jaxlib"):
                    offenders.append(f"{path.relative_to(ROOT)}:{node.lineno} {n}")
    assert not offenders, offenders
