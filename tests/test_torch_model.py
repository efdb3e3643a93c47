"""The port's slice as a whole, on the CPU: the smoke cnn-vgg11 logits of
``repro_torch`` against ``repro``'s on the same weights, the port's import
hygiene, and the process state the port's tests leave alone.

Whole-model tolerance (f32): max |port - repro| <= 1e-4 * max(1, max |repro|)
— four conv stages and two FC layers summed in different orders.
"""

import ast
import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import cnn as jcnn
from repro.models.module import init_params as jax_init_params
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_repro
from repro_torch.models import cnn
from repro_torch.models.module import count_params, init_params

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


def _repro_weights(cfg, seed=0):
    params = jax_init_params(jcnn.param_defs(cfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    # repro initializes biases to zero; make them count in the comparison
    return {k: (np.asarray(v) + (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                                 if k.startswith("bias") or k.endswith("_b") else 0))
            for k, v in params.items()}


def _images(batch, seed=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cnn.IMG, cnn.IMG, cnn.IN_CH)).astype(np.float32)


def test_smoke_configs_agree():
    assert (dataclasses.asdict(smoke_config("cnn-vgg11"))
            == dataclasses.asdict(jax_smoke_config("cnn-vgg11")))


@pytest.mark.parametrize("conv_algorithm", [None, "direct", "im2col"])
def test_smoke_logits_match_repro(conv_algorithm):
    cfg = jax_smoke_config("cnn-vgg11")
    np_params = _repro_weights(cfg)
    images = _images(3)
    want = np.asarray(jcnn.forward(cfg, {k: jnp.asarray(v) for k, v in np_params.items()},
                                   jnp.asarray(images), use_kernels=False))
    tcfg = smoke_config("cnn-vgg11")
    params = params_from_repro(np_params, device="cpu")
    schedules = cnn.plan_forward(tcfg, 3, conv_algorithm=conv_algorithm)
    got = cnn.forward(tcfg, params, torch.from_numpy(images), schedules=schedules)
    assert got.shape == want.shape == (3, cfg.vocab)
    err = float(np.max(np.abs(got.numpy() - want)))
    assert err <= TOL * max(1.0, float(np.max(np.abs(want)))), err
    plain = cnn.forward(tcfg, params, torch.from_numpy(images), use_kernels=False)
    assert float(np.max(np.abs(plain.numpy() - want))) <= TOL * max(1.0, float(np.abs(want).max()))


def test_param_defs_match_repro():
    for arch_cfg in (get_config("cnn-vgg11"), smoke_config("cnn-vgg11")):
        ours = cnn.param_defs(arch_cfg)
        theirs = jcnn.param_defs(arch_cfg)
        assert {k: d.shape for k, d in ours.items()} == {k: d.shape for k, d in theirs.items()}
    assert count_params(cnn.param_defs(get_config("cnn-vgg11"))) == 14_040_680


def test_init_params_is_seeded_and_scaled():
    defs = cnn.param_defs(smoke_config("cnn-vgg11"))
    a = init_params(defs, 5, device="cpu")
    b = init_params(defs, 5, device="cpu")
    c = init_params(defs, 6, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in defs)
    assert not torch.equal(a["fc1"], c["fc1"])
    assert torch.count_nonzero(a["bias0"]) == 0
    fan_in = defs["fc1"].shape[0]
    assert abs(float(a["fc1"].std()) * fan_in ** 0.5 - 1.0) < 0.1


def test_params_from_repro_keeps_layouts():
    cfg = jax_smoke_config("cnn-vgg11")
    np_params = _repro_weights(cfg)
    got = params_from_repro(np_params, device="cpu")
    for k, v in np_params.items():
        assert tuple(got[k].shape) == v.shape and got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v)


# -- import hygiene -------------------------------------------------------------

PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
            elif node.args and isinstance(node.args[0], ast.JoinedStr):
                head = node.args[0].values[0]
                if isinstance(head, ast.Constant):
                    roots.add(str(head.value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    assert path.exists()
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax"}
    assert not bad, f"{path} imports {bad}"


# -- process state ----------------------------------------------------------------


def _state():
    from repro.core import conv_layer as jcl
    from repro.plan import autotune as at
    from repro_torch.core import conv_layer as tcl

    return (dict(os.environ), torch.get_default_dtype(), jax.config.jax_enable_x64,
            at.get_policy(), len(jcl._WARNED_SCHEDULES), len(at._WARNED_CELLS),
            len(tcl._WARNED_SCHEDULES), torch.is_grad_enabled(),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def test_port_leaves_process_state_alone():
    """Running the port (and the repro oracle the tests use) changes no
    environment variable, default dtype, jax flag, autotune policy, warning
    registry, grad mode or TF32 switch — forward or planned backward."""
    before = _state()
    test_smoke_logits_match_repro(None)
    cfg = smoke_config("cnn-vgg11")
    params = {k: v.requires_grad_(True)
              for k, v in params_from_repro(_repro_weights(jax_smoke_config("cnn-vgg11")),
                                            device="cpu").items()}
    logits = cnn.forward(cfg, params, torch.from_numpy(_images(2)),
                         schedules=cnn.plan_training(cfg, 2))
    logits.sum().backward()
    assert _state() == before
