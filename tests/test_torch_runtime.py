"""The port's run settings (``runtime.py``) on the CPU: the import graph, ``using``, and
the resolution tables, written out as every pair resolved before ``runtime.py`` held them."""

import ast
from pathlib import Path

import pytest
import torch

from multimodal_embedding_tpu_torch import runtime
from multimodal_embedding_tpu_torch.ops import maxsim_cuda
from multimodal_embedding_tpu_torch.parallel.mesh import Mesh
from multimodal_embedding_tpu_torch.stats import score_cache

PKG = "multimodal_embedding_tpu_torch"
ROOT = Path(__file__).resolve().parents[1] / PKG


def _imported(path: Path) -> list[str]:
    """The modules the imports in ``path`` name, relative ones resolved,
    outside ``if TYPE_CHECKING:``."""
    tree, package = ast.parse(path.read_text()), [PKG, *path.relative_to(ROOT).parts[:-1]]
    typing_only = {id(n) for t in ast.walk(tree) if getattr(getattr(t, "test", None), "id", "") == "TYPE_CHECKING"
                   for n in ast.walk(t)}
    found = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Import) and id(n) not in typing_only:
            found += [a.name for a in n.names]
        elif isinstance(n, ast.ImportFrom) and id(n) not in typing_only:
            base = package[: len(package) + 1 - n.level] if n.level else []
            mod = ".".join([*base, *filter(None, [n.module])])
            found += [mod, *(f"{mod}.{a.name}" for a in n.names)]
    return found


@pytest.mark.parametrize("where", ["utils", "ops", "parallel", "stats", "retrieval", "data", "runtime.py"])
def test_nothing_below_models_imports_models(where):
    paths = [ROOT / where] if where.endswith(".py") else sorted((ROOT / where).rglob("*.py"))
    banned = PKG if where == "runtime.py" else f"{PKG}.models"  # runtime.py: nothing of the package
    upward = [f"{p.relative_to(ROOT)}: {mod}" for p in paths if p != ROOT / "parallel" / "tp.py"
              for mod in _imported(p) if mod == banned or mod.startswith(f"{banned}.")]
    assert upward == []


def test_using_restores_the_previous_settings_when_its_body_raises():
    before, mesh = runtime.current(), Mesh(1, 2)
    with runtime.using(attention="xla_bf16"):
        with pytest.raises(RuntimeError), runtime.using(layer="fused", tp=mesh):
            assert runtime.current() == runtime.Runtime("xla_bf16", "fused", mesh, None)
            raise RuntimeError("in the body")
        assert runtime.current() == runtime.Runtime(attention="xla_bf16")
    assert runtime.current() is before


@pytest.mark.parametrize("changes, error, message", [
    ({"attention": "nope"}, ValueError,
     "attention impl must be one of ('auto', 'xla', 'xla_bf16', 'pallas', 'flash'), not 'nope'"),
    ({"layer": "pallas"}, ValueError, "layer impl must be one of ('auto', 'xla', 'fused'), not 'pallas'"),
    ({"preprocess": "xla"}, TypeError, "preprocess"),
])
def test_using_rejects_a_bad_name_before_changing_anything(changes, error, message):
    before = runtime.current()
    with pytest.raises(error) as info, runtime.using(tp=Mesh(1, 2), **changes):
        pass
    assert message in str(info.value) and runtime.current() is before


def test_a_mesh_with_one_model_rank_is_stored_as_none():
    with runtime.using(tp=Mesh(4, 1), sp=Mesh(2, 1)) as rt:
        assert rt.tp is None and rt.sp is None
    tp, sp = Mesh(2, 2), Mesh(1, 2)
    with runtime.using(tp=tp, sp=sp) as rt:
        assert rt.tp is tp and rt.sp is sp


@pytest.mark.parametrize("impl, device, want", [
    ("auto", "cpu", "xla"), ("auto", "cuda", "pallas"), ("xla", "cpu", "xla"), ("xla", "cuda", "xla"),
    ("xla_bf16", "cpu", "xla_bf16"), ("xla_bf16", "cuda", "xla_bf16"), ("pallas", "cpu", "pallas"),
    ("pallas", "cuda", "pallas"), ("flash", "cpu", "flash"), ("flash", "cuda", "flash"),
])
def test_resolve_and_attention_reader_table(impl, device, want):
    assert runtime.resolve(impl, device) == runtime.resolve(impl, torch.device(device)) == want
    with runtime.using(attention=impl):
        assert runtime.attention_impl(torch.device(device)) == want


@pytest.mark.parametrize("impl, want", [("auto", "xla"), ("xla", "xla"), ("fused", "fused")])
def test_layer_reader_table(impl, want):
    with runtime.using(layer=impl):
        assert runtime.layer_impl() == want


@pytest.mark.parametrize("impl, device, want", [  # CPU tensors always take the plain version
    ("auto", "cpu", "xla"), ("auto", "cuda", "pallas"), ("pallas", "cpu", "xla"), ("pallas", "cuda", "pallas"),
    ("xla", "cpu", "xla"), ("xla", "cuda", "xla"),
])
def test_maxsim_route_table(impl, device, want):
    assert maxsim_cuda.route(impl, torch.device(device)) == want


@pytest.mark.parametrize("settings, preprocess, maxsim, device, want", [
    ({"tp": Mesh(2, 2)}, "pallas", "pallas", "cpu", "torch-cpu-xla-xla-pallas-xla-tp2"),
    ({"tp": Mesh(4, 1), "sp": Mesh(1, 4)}, "auto", "auto", "cpu", "torch-cpu-xla-xla-xla-xla-sp4"),
    ({}, "auto", "auto", "cuda", "torch-NVIDIA_H100_80GB_HBM3-pallas-xla-pallas-pallas"),
    ({"attention": "xla", "layer": "fused", "sp": Mesh(2, 2)}, "xla", "auto", "cuda:0",
     "torch-NVIDIA_H100_80GB_HBM3-xla-fused-xla-pallas-sp2"),
])
def test_numerics_fingerprint_table(monkeypatch, settings, preprocess, maxsim, device, want):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    with runtime.using(**settings):
        assert score_cache.numerics_fingerprint(preprocess, maxsim, device=device) == want
