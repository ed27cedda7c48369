"""The PyTorch port stands alone: no JAX, no ``repro``, no quiet CPU.

* every module of ``repro_torch`` imports in a process where ``jax`` and
  ``repro`` are poisoned in ``sys.modules``;
* no file of the port (nor ``chip_smoke.py``) names them in an import;
* entry points raise without a card unless ``device="cpu"`` was asked
  for, and the kernel build raises when there is no compiler.
"""
import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from torch_system import one_thread  # noqa: F401 (a fixture)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")


def test_import_with_jax_and_repro_poisoned():
    code = textwrap.dedent("""
        import pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            __import__(name)
        assert not any(k == "jax" or k.startswith("jax.")
                       for k, v in sys.modules.items() if v is not None)
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was walked


def test_carbon_and_obs_import_with_jax_and_repro_poisoned():
    """The carbon package's lazy exports and the flight recorder resolve
    with ``jax`` and ``repro`` poisoned, and pull neither in."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.carbon as carbon
        import repro_torch.obs as obs
        for name in carbon.__all__:
            getattr(carbon, name)
        for name in obs.__all__:
            getattr(obs, name)
        from repro_torch.obs import env
        assert "jax" not in env.env_info()
        mods = sorted(k for k, v in sys.modules.items() if v is not None
                      and k.startswith(("repro_torch.carbon.",
                                        "repro_torch.obs.")))
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k, v in sys.modules.items() if v is not None)
        print(" ".join(mods))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "repro_torch.carbon.controller", "repro_torch.carbon.intensity",
        "repro_torch.carbon.ledger", "repro_torch.obs.env",
        "repro_torch.obs.events", "repro_torch.obs.metrics",
        "repro_torch.obs.trace"]


def test_training_modules_import_with_jax_and_repro_poisoned():
    """The training path - optimizers, trainer, checkpoints, the batch
    pipeline, the experiment, DIN's config and the training CLI - stands
    alone: imported with ``jax`` and ``repro`` poisoned, it pulls in
    neither."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.training.optimizer
        import repro_torch.training.trainer
        import repro_torch.training.checkpoint
        import repro_torch.experiments
        import repro_torch.data.pipeline
        import repro_torch.configs.din_arch
        import repro_torch.launch.train
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k, v in sys.modules.items() if v is not None)
        print(" ".join(sorted(k for k, v in sys.modules.items()
                              if v is not None and k.startswith(
                                  "repro_torch.training."))))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["repro_torch.training.checkpoint",
                                  "repro_torch.training.optimizer",
                                  "repro_torch.training.trainer"]


def test_multihost_modules_import_with_jax_and_repro_poisoned():
    """The request mesh, the shard-ordered sums, multi-process serving
    and the serving CLI that drives them stand alone: imported with
    ``jax`` and ``repro`` poisoned, they pull in neither."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.distributed.sharding
        import repro_torch.distributed.multihost
        import repro_torch.launch.mesh
        import repro_torch.launch.serve
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k, v in sys.modules.items() if v is not None)
        print(" ".join(sorted(k for k, v in sys.modules.items()
                              if v is not None and k.startswith(
                                  "repro_torch.distributed"))))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["repro_torch.distributed",
                                  "repro_torch.distributed.multihost",
                                  "repro_torch.distributed.sharding"]


def test_training_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch import experiments
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "din", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiments.build_experiment()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiments.build_serving_stack(small=True, cache=False)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [(f, r) for f in files for r in _imported_roots(f)
           if r in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_stack(users=100, requests=8, windows=1, small=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--small", "--windows", "1", "--requests", "8"])
    assert resolve_device("cpu").type == "cpu"


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    from repro_torch.kernels import build

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()


def test_kernel_build_compiles_every_source_for_sm90a(monkeypatch,
                                                      tmp_path):
    """The extension is built from the repository's sources, for
    ``sm_90a``, into the build directory (the compile itself needs a
    GPU machine, so ``cpp_extension.load`` is recorded, not run)."""
    from torch.utils import cpp_extension

    from repro_torch.kernels import build

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("")
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(build, "_EXT", None)
    seen = {}
    monkeypatch.setattr(cpp_extension, "load",
                        lambda **kw: seen.update(kw) or "ext")
    assert build.load() == "ext" and build.load() == "ext"
    assert "-gencode=arch=compute_90a,code=sm_90a" in \
        seen["extra_cuda_cflags"]
    assert sorted(os.path.basename(s) for s in seen["sources"]) == [
        "bind.cpp", "cascade_truncate.cu", "cin.cu", "cin_bwd.cu",
        "dot_interact.cu", "dot_interact_bwd.cu", "embedding_bag.cu",
        "embedding_bag_bwd.cu", "flash_attention.cu",
        "flash_attention_bwd.cu", "flash_attention_wgmma.cu",
        "target_attention.cu", "target_attention_bwd.cu"]
    assert all(os.path.exists(s) for s in seen["sources"])
    assert seen["build_directory"] == str(tmp_path / "b")


def test_kernel_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain path; anything else that is not
    CUDA raises instead of falling back."""
    from repro_torch.kernels import ops

    meta = torch.empty((2, 3, 4), device="meta", dtype=torch.int32)
    idx = torch.empty(2, device="meta", dtype=torch.int32)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.cascade_truncate(meta, meta.float(), idx, idx, idx, expose=2)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.embedding_bag(torch.zeros(4, 2), idx.reshape(1, 2))


def test_serve_cli_runs_on_the_cpu_when_asked(capsys, one_thread):
    from repro_torch.launch import serve

    assert serve.main(["--small", "--device", "cpu", "--source",
                       "generated", "--scenario", "constant", "--windows",
                       "2", "--requests", "32", "--users", "2000"]) == 0
    out = capsys.readouterr().out
    assert "device cpu" in out and "worst overshoot vs cap: 0.000%" in out
