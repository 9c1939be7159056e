"""The port's ``.pth`` -> Flax ``.npz`` conversion against the JAX package's.

``pnp_svrg_tpu_torch/models/convert.py`` keeps its own copy of
``pnp_svrg_tpu/models/convert.py``'s functions. Each is held here to the JAX
function on the same inputs, array for array and bit for bit, on
numpy-seeded synthetic checkpoints in the reference's three layouts:

* ``module.dncnn.N.*``: a DnCNN with BatchNorm, the state dict of an
  ``nn.DataParallel`` of a module whose ``dncnn`` is an ``nn.Sequential``;
* ``dncnn.N.*``: a SimpleCNN state dict, no BatchNorm;
* a fully pickled ``nn.DataParallel`` of a ``models.basic_models.simple_CNN``
  (the MMO files), saved while stub ``models`` modules stand in
  ``sys.modules`` and loaded after they are gone, so that both loaders take
  their stub path. ``monkeypatch`` removes every ``models`` module the test
  or a loader registers.

Then both packages' ``convert_all`` run on one synthetic reference tree
(one source missing, and skipped), the committed ``checkpoints/*.npz`` are
rebuilt as ``.pth`` files and converted back, and every output is loaded
into the port's model and run against the source module.
"""

from __future__ import annotations

import sys
import time
import types
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from pnp_svrg_tpu.models import convert as jconv
from pnp_svrg_tpu_torch.models import convert as tconv
from pnp_svrg_tpu_torch.models.dncnn import DnCNN, MMOSimpleCNN

CHECKPOINTS = Path(__file__).resolve().parents[1] / "checkpoints"
# The layouts' synthetic sizes: (depth, features); channels 1.
SMALL = {"dncnn": (5, 8), "simplecnn": (4, 8), "mmo": (5, 8)}
# The committed checkpoints the rebuild covers, one per layout, and the
# CONVERSIONS name (and so the source path) each is written under.
COMMITTED = {"dncnn": "dncnn_noise5", "simplecnn": "simplecnn_noise5", "mmo": "mmo_dncnn_nobn_nch1_nlev0.01"}
LAYOUTS = list(SMALL)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Ref(nn.Module):
    """The reference's DnCNN / SimpleCNN: its layers in ``self.dncnn``."""

    def __init__(self, depth: int, features: int, bn: bool):
        super().__init__()
        layers = [nn.Conv2d(1, features, 3, padding=1, bias=False), nn.ReLU()]
        for _ in range(depth - 2):
            layers.append(nn.Conv2d(features, features, 3, padding=1, bias=False))
            if bn:
                layers.append(nn.BatchNorm2d(features, eps=1e-5))
            layers.append(nn.ReLU())
        layers.append(nn.Conv2d(features, 1, 3, padding=1, bias=False))
        self.dncnn = nn.Sequential(*layers)

    def forward(self, x):
        return self.dncnn(x)


def _mmo_class():
    """A ``simple_CNN`` class whose pickle names ``models.basic_models``
    (in_conv, conv_list, out_conv; LeakyReLU(0.01) and the input skip, as
    the port's ``MMOSimpleCNN``)."""

    class simple_CNN(nn.Module):  # noqa: N801 (reference class name)
        def __init__(self, depth: int, features: int):
            super().__init__()
            self.in_conv = nn.Conv2d(1, features, 3, padding=1)
            self.conv_list = nn.ModuleList(nn.Conv2d(features, features, 3, padding=1) for _ in range(depth - 2))
            self.out_conv = nn.Conv2d(features, 1, 3, padding=1)

        def forward(self, x):
            y = nn.functional.leaky_relu(self.in_conv(x), 0.01)
            for conv in self.conv_list:
                y = nn.functional.leaky_relu(conv(y), 0.01)
            return self.out_conv(y) + x

    simple_CNN.__module__ = "models.basic_models"
    simple_CNN.__qualname__ = "simple_CNN"
    return simple_CNN


def _register_stub(monkeypatch, cls) -> None:
    pkg, basic = types.ModuleType("models"), types.ModuleType("models.basic_models")
    basic.simple_CNN = cls
    pkg.basic_models = basic
    monkeypatch.setitem(sys.modules, "models", pkg)
    monkeypatch.setitem(sys.modules, "models.basic_models", basic)


def _forget_stub(monkeypatch) -> None:
    """No ``models`` module left: the next load takes the stub path."""
    for name in ("models.basic_models", "models"):
        monkeypatch.delitem(sys.modules, name, raising=False)


@torch.no_grad()
def _seed(module: nn.Module, seed: int) -> nn.Module:
    """Every parameter and float buffer from a numpy seed (variances
    positive), in eval mode."""
    rng = np.random.default_rng(seed)
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        if t.dtype.is_floating_point:
            v = rng.standard_normal(t.shape).astype(np.float32) * 0.2
            t.copy_(torch.from_numpy(np.abs(v) + 0.5 if name.endswith("running_var") else v))
    return module.eval()


def _make(layout: str, monkeypatch, seed: int = 0):
    """A source module of ``layout`` at :data:`SMALL`'s size and the object
    its ``.pth`` holds."""
    depth, features = SMALL[layout]
    if layout == "mmo":
        cls = _mmo_class()
        _register_stub(monkeypatch, cls)
        src = _seed(cls(depth, features), seed)
        return src, nn.DataParallel(src)
    src = _seed(_Ref(depth, features, bn=layout == "dncnn"), seed)
    return src, (nn.DataParallel(src).state_dict() if layout == "dncnn" else src.state_dict())


def _save(obj, path: Path) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(obj, path)
    return path


def _flat_equal(a: dict, b: dict) -> None:
    fa, fb = jconv._flatten(a), tconv._flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape and np.array_equal(fa[k], fb[k]), k


def _port_model(layout: str, variables: dict, depth: int, features: int) -> nn.Module:
    if layout == "mmo":
        model = MMOSimpleCNN(channels=1, depth=depth, features=features)
    else:
        model = DnCNN(channels=1, depth=depth, features=features, use_bn=layout == "dncnn")
    model.load_state_dict(tconv.torch_state_dict_from_flax(variables, model))
    return model.eval()


def _forward_equal(layout: str, src: nn.Module, variables: dict, depth: int, features: int) -> None:
    x = torch.tensor(np.random.default_rng(7).uniform(0, 1, (2, 1, 32, 32)).astype(np.float32))
    with torch.no_grad():
        want, got = src(x), _port_model(layout, variables, depth, features)(x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("prefix", ["module.", "net."])
def test_strip_prefix_matches_jax(prefix):
    sd = {"module.dncnn.0.weight": 1, "net.3.bias": 2, "dncnn.module.1": 3, "module.": 4}
    assert tconv._strip_prefix(sd, prefix) == jconv._strip_prefix(sd, prefix)
    assert tconv._strip_prefix(sd) == jconv._strip_prefix(sd)


@pytest.mark.parametrize("shape", [(64, 1, 3, 3), (1, 64, 3, 3), (5, 7, 3, 2)])
def test_conv_to_flax_matches_jax(shape):
    w = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got, want = tconv._conv_to_flax(w), jconv._conv_to_flax(w)
    assert got.flags["C_CONTIGUOUS"] and got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_load_and_map_match_jax(layout, tmp_path, monkeypatch):
    src, obj = _make(layout, monkeypatch)
    path = _save(obj, tmp_path / f"{layout}.pth")
    _forget_stub(monkeypatch)
    sd_port = tconv._load_torch_state_dict(path)
    _forget_stub(monkeypatch)
    sd_jax = jconv._load_torch_state_dict(path)
    assert list(sd_port) == list(sd_jax)
    assert all(torch.equal(sd_port[k], sd_jax[k]) for k in sd_port)
    assert not any(k.startswith("module.") for k in sd_port)
    to_flax = "mmo_simple_cnn_to_flax" if layout == "mmo" else "sequential_dncnn_to_flax"
    got, want = getattr(tconv, to_flax)(sd_port), getattr(jconv, to_flax)(sd_jax)
    _flat_equal(want, got)
    assert ("batch_stats" in got) == (layout == "dncnn")
    _forward_equal(layout, src, got, *SMALL[layout])


def test_constants_match_jax():
    assert tconv.CONVERSIONS == jconv.CONVERSIONS
    assert tconv.DEFAULT_OUT == jconv.DEFAULT_OUT == CHECKPOINTS
    # The reference checkout beside the repository, as utils/io.py's.
    from pnp_svrg_tpu_torch.utils.io import REFERENCE_DATA_DIR

    assert tconv.REFERENCE_ROOT == REFERENCE_DATA_DIR.parent == CHECKPOINTS.parent.parent / "reference"


class _FixedClock(types.SimpleNamespace):
    """``zipfile``'s clock stopped, so that two ``.npz`` writes stamp their
    members alike."""

    def __init__(self):
        super().__init__(time=lambda: 1.6e9, localtime=time.localtime)


def _tree(root: Path, monkeypatch) -> dict:
    """A reference tree holding one source of each layout at its
    CONVERSIONS path (every other source missing); returns name -> source
    module."""
    names = {"dncnn": "dncnn_noise15", "simplecnn": "simplecnn_noise40", "mmo": "mmo_dncnn_nobn_nch3_nlev0.007"}
    out = {}
    for seed, (layout, name) in enumerate(names.items()):
        src, obj = _make(layout, monkeypatch, seed)
        _save(obj, root / tconv.CONVERSIONS[name])
        out[name] = (layout, src)
    _forget_stub(monkeypatch)
    return out


def test_convert_all_writes_byte_equal_npz_in_every_layout(tmp_path, monkeypatch, capsys):
    sources = _tree(tmp_path / "reference", monkeypatch)
    monkeypatch.setattr(zipfile, "time", _FixedClock())
    got = tconv.convert_all(tmp_path / "port", tmp_path / "reference")
    _forget_stub(monkeypatch)
    want = jconv.convert_all(tmp_path / "jax", tmp_path / "reference")
    assert got == want == [n for n in tconv.CONVERSIONS if n in sources]
    printed = capsys.readouterr().out
    assert printed.count("skip ") == 2 * (len(tconv.CONVERSIONS) - len(sources))
    for name, (layout, src) in sources.items():
        assert (tmp_path / "port" / f"{name}.npz").read_bytes() == (tmp_path / "jax" / f"{name}.npz").read_bytes()
        variables = tconv.load_flax_npz(tmp_path / "port" / f"{name}.npz")
        _flat_equal(jconv.load_flax_npz(tmp_path / "jax" / f"{name}.npz"), variables)
        _forward_equal(layout, src, variables, *SMALL[layout])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_committed_checkpoints_rebuilt_as_pth_convert_back(layout, tmp_path, monkeypatch):
    """``chip_smoke.py``'s ``reference_checkpoint`` rebuilds each committed
    checkpoint in its reference layout (the inverse of the mapping); the
    port's ``convert_all`` gives the committed arrays back, and the output
    runs the source module's forward."""
    import chip_smoke

    for mod in ("models", "models.basic_models"):  # chip_smoke registers its stubs; removed after the test
        monkeypatch.setitem(sys.modules, mod, types.ModuleType(mod))
        monkeypatch.delitem(sys.modules, mod)
    name = COMMITTED[layout]
    variables = tconv.load_flax_npz(CHECKPOINTS / f"{name}.npz")
    flat = tconv._flatten(variables)
    depth = sum(k.endswith("/kernel") for k in flat)
    features = flat["params/Conv_0/kernel"].shape[-1]
    obj = chip_smoke.reference_checkpoint(name, variables)
    if layout == "mmo":
        assert isinstance(obj, nn.DataParallel) and type(obj.module).__module__ == "models.basic_models"
        src = _mmo_class()(depth, features).eval()  # the same modules, with the reference's forward
        src.load_state_dict(obj.module.state_dict())
    else:
        assert chip_smoke.CONVERT_LAYOUTS[name] == ("module.dncnn" if layout == "dncnn" else "dncnn")
        assert all(k.startswith(chip_smoke.CONVERT_LAYOUTS[name] + ".") for k in obj)
        src = _Ref(depth, features, bn=layout == "dncnn").eval()
        src.load_state_dict(tconv._strip_prefix(obj))
    _save(obj, tmp_path / "reference" / tconv.CONVERSIONS[name])
    _forget_stub(monkeypatch)
    assert tconv.convert_all(tmp_path / "out", tmp_path / "reference") == [name]
    with np.load(CHECKPOINTS / f"{name}.npz") as want, np.load(tmp_path / "out" / f"{name}.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    _forward_equal(layout, src, tconv.load_flax_npz(tmp_path / "out" / f"{name}.npz"), depth, features)


def test_no_models_module_is_left_behind():
    assert "models" not in sys.modules and "models.basic_models" not in sys.modules

