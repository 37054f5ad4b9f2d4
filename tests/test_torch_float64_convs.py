"""``torch_port.float64_convolutions_as_dots``, the lowering the float64
references compile their convolutions with, against XLA's own: outputs and
both gradients (the transposed convolutions: dilated inputs, negative
padding, a kernel larger than the output) of float64 convolutions at
strides, dilations, paddings and layouts within 1e-13 * max|ref|, with no
convolution left in the program; a grouped or fp32 convolution keeps XLA's
own; the lowering table is restored after the block."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax._src.interpreters import mlir
from torch_port import float64_convolutions_as_dots

CONVS = {  # lhs, rhs, strides, padding, lhs dilation, rhs dilation, layouts
    "3x3 same": ((2, 9, 13, 5), (3, 3, 5, 4), (1, 1), "SAME", (1, 1), (1, 1), ("NHWC", "HWIO", "NHWC")),
    "5x5 stride 2": ((2, 9, 13, 5), (5, 5, 5, 4), (2, 2), "SAME", (1, 1), (1, 1), ("NHWC", "HWIO", "NHWC")),
    "dilated, padded": ((2, 9, 13, 5), (3, 3, 5, 4), (1, 2), ((2, 1), (0, 3)), (1, 1), (2, 3),
                        ("NHWC", "HWIO", "NHWC")),
    "input dilation, NCHW": ((2, 5, 12, 9), (4, 5, 3, 3), (1, 1), ((1, 2), (1, 1)), (2, 2), (1, 1),
                             ("NCHW", "OIHW", "NCHW")),
    "1x1": ((1, 8, 8, 3), (1, 1, 3, 7), (1, 1), "VALID", (1, 1), (1, 1), ("NHWC", "HWIO", "NHWC")),
    "negative padding": ((2, 6, 10, 4), (4, 4, 4, 3), (2, 2), ((-1, 2), (1, -1)), (1, 1), (1, 1),
                         ("NHWC", "HWIO", "NHWC")),
}


def value_and_grads(conv, x, w):
    def f(x, w):
        y = conv(x, w)
        return jnp.sum(jnp.sin(y)), y
    fn = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    return fn(x, w), fn.lower(x, w).as_text()


@pytest.mark.parametrize("name", sorted(CONVS))
def test_float64_convolutions_as_dots_match_xla(name):
    xs, ws, strides, padding, ld, rd, dn = CONVS[name]
    rng = np.random.default_rng(0)
    conv = lambda x, w: lax.conv_general_dilated(x, w, strides, padding, ld, rd,  # noqa: E731
                                                 dimension_numbers=dn)
    with jax.enable_x64(True):
        x, w = (jnp.asarray(rng.standard_normal(s)) for s in (xs, ws))
        ref, ref_hlo = value_and_grads(conv, x, w)
        with float64_convolutions_as_dots():
            got, hlo = value_and_grads(conv, x, w)
    assert "convolution" in ref_hlo and "convolution" not in hlo
    # the output and both gradients (the scalar is a sum that cancels)
    (_, y), grads = got
    (_, y_ref), grads_ref = ref
    for a, b in zip((y, *grads), (y_ref, *grads_ref)):
        assert a.dtype == b.dtype == jnp.float64 and a.shape == b.shape
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-13 * np.abs(np.asarray(b)).max()


def test_grouped_and_fp32_convolutions_keep_xla():
    rng = np.random.default_rng(1)
    grouped = lambda x, w: lax.conv_general_dilated(  # noqa: E731
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=2)
    with jax.enable_x64(True):
        for dtype in (np.float64, np.float32):
            x, w = rng.standard_normal((1, 6, 7, 4)).astype(dtype), rng.standard_normal((3, 3, 2, 6)).astype(dtype)
            ref, _ = value_and_grads(grouped, x, w)
            with float64_convolutions_as_dots():
                got, hlo = value_and_grads(grouped, x, w)
            assert "convolution" in hlo
            for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_lowering_table_restored():
    table = mlir._platform_specific_lowerings["cpu"]
    held = table[lax.conv_general_dilated_p]
    with pytest.raises(RuntimeError):
        with float64_convolutions_as_dots():
            assert table[lax.conv_general_dilated_p] is not held
            raise RuntimeError
    assert table[lax.conv_general_dilated_p] is held
