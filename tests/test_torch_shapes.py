"""The port's assigned input shapes (``repro_torch.configs.shapes``) against
the reference's ``repro.configs.shapes``: the four ``SHAPES``, the skip rule
for all 10 archs × 4 shapes, and every supported cell's ``input_specs``
(meta tensors against ``ShapeDtypeStruct``s) in the train dtypes and in the
dry run's serve dtypes (bf16)."""

import dataclasses

import pytest

from repro_torch import configs as tconfigs
from repro_torch.configs import shapes as tshapes

jax = pytest.importorskip("jax")

from repro import configs as rconfigs  # noqa: E402
from repro.configs import shapes as rshapes  # noqa: E402

SERVE_DTYPES = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def test_shapes_table_equals_reference():
    assert list(tshapes.SHAPES) == list(rshapes.SHAPES)
    for name, sp in tshapes.SHAPES.items():
        assert dataclasses.astuple(sp) == \
            dataclasses.astuple(rshapes.SHAPES[name])


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cell_supported_equals_reference(arch):
    for shape in tshapes.SHAPES:
        assert tshapes.cell_supported(tconfigs.get(arch), shape) == \
            rshapes.cell_supported(rconfigs.get(arch), shape), shape


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_input_specs_equal_reference(arch):
    """Shapes and dtypes of every input of every supported cell; meta
    tensors, so nothing is allocated."""
    for shape, sp in tshapes.SHAPES.items():
        overrides = {} if sp.kind == "train" else SERVE_DTYPES
        tcfg = tconfigs.get(arch, **overrides)
        if tshapes.cell_supported(tcfg, shape):
            continue
        got = tshapes.input_specs(tcfg, shape)
        want = rshapes.input_specs(rconfigs.get(arch, **overrides), shape)
        assert list(got) == list(want), (arch, shape)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (arch, shape, k)
            assert str(v.dtype).removeprefix("torch.") == \
                str(want[k].dtype), (arch, shape, k)
