"""Package boundary of the PyTorch port: it imports nothing of JAX or of
the JAX package, every module imports without triton/nvcc/a card, the
dispatch never runs a plain version on a non-CPU tensor, and entry points
refuse to fall back to the CPU."""
import ast
import importlib
import json
import pkgutil
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.kernels import build, ops

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_without_a_toolchain():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch.")]
    assert len(names) >= 25
    loaded = dict(build._LIBS)
    for name in names:
        importlib.import_module(name)
    assert build._LIBS == loaded, "importing must not build or load a kernel"


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("op,kernel_mod,plain_name,args,kw", [
    ("quant_matmul", "quant_matmul", "quant_matmul_plain",
     lambda: (_meta(8, 64), _meta(64, 16, dtype=torch.uint8), _meta(32),
              _meta(32)), {"cpb": 2}),
    ("flash_attention", "flash_attention", "flash_attention_plain",
     lambda: (_meta(1, 16, 4, 8, dtype=torch.bfloat16),
              _meta(1, 16, 2, 8, dtype=torch.bfloat16),
              _meta(1, 16, 2, 8, dtype=torch.bfloat16)), {}),
    ("comq_panel_dq", "comq_panel", "comq_panel_dq_plain",
     lambda: (_meta(8, 8), _meta(8, 4), _meta(8, 4), _meta(4), _meta(4),
              _meta(4), _meta(8)), {}),
    ("paged_attention", "paged_attention", "paged_attention_plain",
     lambda: (_meta(2, 4, 16, dtype=torch.bfloat16),
              _meta(6, 4, 2, 16, dtype=torch.bfloat16),
              _meta(6, 4, 2, 16, dtype=torch.bfloat16),
              _meta(2, 3, dtype=torch.int32), _meta(2, dtype=torch.int32)),
     {"window": 0}),
    ("paged_attention_quant", "paged_attention",
     "paged_attention_quant_plain",
     lambda: (_meta(2, 4, 16, dtype=torch.bfloat16),
              _meta(6, 4, 2, 8, dtype=torch.uint8),
              _meta(6, 4, 2, 8, dtype=torch.uint8), _meta(6, 2), _meta(6, 2),
              _meta(2, 3, dtype=torch.int32), _meta(2, dtype=torch.int32)),
     {"kv_bits": 4}),
])
def test_dispatch_never_runs_plain_on_a_device_tensor(monkeypatch, op,
                                                      kernel_mod, plain_name,
                                                      args, kw):
    """A non-CPU tensor reaches the kernel wrapper, which refuses anything
    but CUDA; the plain version is never called."""
    mod = importlib.import_module(f"repro_torch.kernels.{kernel_mod}")

    def forbidden(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    monkeypatch.setattr(mod, plain_name, forbidden)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        getattr(ops, op)(*args(), **kw)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.device import resolve_device
    from repro_torch.launch import quantize
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        quantize.main(["--arch", "qwen2-7b", "--smoke"])


# the JAX quantize launcher's flags that the port once refused: each one
# runs now (--shard-data as a world of one in this process)
@pytest.mark.parametrize("flag", ["--journal", "--shard-data", "--trace"])
def test_launcher_rejects_unported_flags(flag, capsys, tmp_path):
    from repro_torch.launch import quantize
    from repro_torch.obs import validate_trace_file
    argv = ["--arch", "qwen2-7b", "--smoke", "--device", "cpu", flag]
    if flag != "--shard-data":
        argv.append(str(tmp_path))
    out = quantize.main(argv + ["--method", "rtn", "--calib-batch", "2",
                                "--calib-seq", "48"])
    assert out["layers_quantized"] == 14 and out["resumed_leaves"] == 0
    assert (out["data_shards"], out["model_shards"]) == (1, 1)
    assert "not yet ported" not in capsys.readouterr().err
    if flag == "--trace":
        path = tmp_path / "quantize.g0.trace.json"
        assert validate_trace_file(str(path)) == []
        spans = [e["name"] for e in json.loads(path.read_text())
                 ["traceEvents"]]
        # 2 layers of 4 tap groups each
        assert spans.count("layer") == 2
        assert spans.count("leaf_solve") == 8
    if flag == "--shard-data":
        assert not torch.distributed.is_initialized()


def test_unported_arch_says_so():
    """Every JAX architecture is registered; a name outside the registry
    says it is not ported."""
    from repro_torch.configs import get_config, list_archs
    assert {"llama-3.2-vision-90b", "vit-base-16"} <= set(list_archs())
    with pytest.raises(KeyError, match="not ported"):
        get_config("llama-3.2-vision-11b")


# the training slice's modules, each beside its JAX counterpart's name
TRAINING_MODULES = ["data/synthetic.py", "data/loader.py",
                    "optim/__init__.py", "optim/adamw.py",
                    "optim/schedule.py",
                    "train/train_step.py", "train/trainer.py",
                    "launch/train.py"]


@pytest.mark.parametrize("rel", TRAINING_MODULES)
def test_training_modules_import_no_jax(rel):
    """Each training module exists beside its JAX counterpart's name and
    imports nothing of JAX or the JAX package."""
    path = PKG / rel
    assert path.is_file() and (ROOT / "src" / "repro" / rel).is_file()
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_backward_kernel_is_counted_and_refuses_a_non_cuda_tensor():
    """flash_attention_bwd is a kernel of its own in the launch counts, and
    its wrapper refuses anything but CUDA tensors (no plain fallback)."""
    from repro_torch.kernels import flash_attention
    assert "flash_attention_bwd" in build.SOURCES
    ops.reset_launch_counts()
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    q = _meta(1, 8, 2, 16, dtype=torch.bfloat16)
    lse = _meta(1, 2, 8)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        flash_attention.flash_attention_bwd_cuda(q, q, q, q, lse)


def _jax_flags(path: Path):
    """The `--flag` strings a module passes to add_argument (read from its
    source: the JAX launcher is not imported here)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return {a.value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_argument"
            for a in node.args if isinstance(a, ast.Constant)
            and str(a.value).startswith("--")}


def test_train_launcher_has_the_jax_flags_plus_device():
    """launch.train takes JAX's launcher flags and --device, no others."""
    from repro_torch.launch import train
    flags = {o for a in train.build_parser()._actions
             for o in a.option_strings if o.startswith("--")} - {"--help"}
    jax_flags = _jax_flags(ROOT / "src" / "repro" / "launch" / "train.py")
    assert "--moment-dtype" in jax_flags
    assert flags == jax_flags | {"--device"}
