"""The frozen arithmetic against the figures PERF.md's kernel table gives,
the kernel families, the correlation sites and the operation counts."""
import pytest

from benchmark import yardstick
from benchmark.reference import nets

SERVE_SITE = (16, 64, 120, 352)


def test_corr1d_fp32_bytes_and_bound():
    nbytes, flops = yardstick.corr_bytes_flops("corr1d", SERVE_SITE)
    assert nbytes / 1e6 == pytest.approx(354.4, abs=0.05)
    assert nbytes / yardstick.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.1058, abs=5e-5)
    assert flops / 1e9 == pytest.approx(1.47, abs=0.005)
    assert yardstick.bound_s(nbytes, flops) == nbytes / yardstick.HBM_BYTES_PER_S


def test_corr2d_forward_and_backward_counts():
    nbytes, flops = yardstick.corr_bytes_flops("corr2d", SERVE_SITE)
    assert flops / 1e9 == pytest.approx(25.00, abs=0.005)
    assert nbytes / 1e6 == pytest.approx(488.1, abs=0.05)
    # the backward at the training shape: 6.67 GFLOP, 111.2 MB in fp32
    nbytes, flops = yardstick.corr_bytes_flops("corr2d", (8, 32, 64, 352), backward=True)
    assert flops / 1e9 == pytest.approx(6.67, abs=0.005)
    assert nbytes / 1e6 == pytest.approx(111.2, abs=0.05)
    # bf16 halves the bytes; TF32's peak is the fp32 inputs' bound for operations
    assert yardstick.corr_bytes_flops("corr2d", SERVE_SITE, "bfloat16")[0] * 2 == pytest.approx(
        yardstick.corr_bytes_flops("corr2d", SERVE_SITE)[0])
    assert yardstick.bound_s(0.0, 495e12) == pytest.approx(1.0)


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::corr1d_fp32_kernel<true>(float const*, float const*)", "corr1d"),
    ("void (anonymous namespace)::corr::bwd_fp32_kernel<true>(float const*)", "corr1d_backward"),
    ("void corr2d_bwd_relayout_kernel<float>(float const*)", "corr2d_backward"),
    ("void (anonymous namespace)::corr2d_bwd_fp32_kernel<true>(float const*)", "corr2d_backward"),
    ("void (anonymous namespace)::corr2d_fp32_kernel<true>(float const*)", "corr2d"),
    ("sm90_xmma_fprop_implicit_gemm_tf32f32_tf32f32_f32_nhwckrsc_nhwc", "convolution"),
    ("void at::native::batch_norm_collect_statistics_channels_last_kernel<float>", "batch_norm"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>", "concatenate"),
    ("void at::native::upsample_bilinear2d_nhwc_out_frame<float, float>", "resize"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise"),
    ("Memcpy DtoD (Device -> Device)", "other"),
])
def test_families(name, family):
    assert yardstick.family(name) == family


@pytest.mark.parametrize("net,kernel", [("sdnet_mini_ext", "corr1d"), ("sdnet", "corr2d")])
def test_corr_sites(net, kernel):
    assert nets.corr_sites(net, 32, 256, 512) == [(kernel, (32, 32, 64, 352))]
    assert nets.corr_sites(net, 8, 512, 960) == [(kernel, (8, 64, 120, 352))]


@pytest.mark.parametrize("net", ["sdnet_mini_ext", "sdnet"])
def test_model_flops(net):
    losses = ["cross_entropy", "lovasz_loss"]
    serve = yardstick.model_flops(net, 2, losses, 1, 64, 128, train=False)
    train = yardstick.model_flops(net, 2, losses, 1, 64, 128, train=True)
    assert 0 < serve < train < 3.5 * serve
    # twice the pixels, twice the operations
    assert yardstick.model_flops(net, 2, losses, 2, 64, 128, train=False) == pytest.approx(
        2 * serve, rel=1e-6)


def test_a_net_added_as_a_module_is_found(monkeypatch):
    import sys
    import types

    toy = types.ModuleType("benchmark.reference.net_toy")
    toy.build = lambda labels: ("toy", labels)
    toy.corr_sites = lambda b, h, w: [("corr1d", (b, h // 8, w // 8, 64))]
    monkeypatch.setitem(sys.modules, toy.__name__, toy)
    assert nets.build("toy", 3) == ("toy", 3)
    assert nets.corr_sites("toy", 2, 64, 128) == [("corr1d", (2, 8, 16, 64))]
    with pytest.raises(ValueError):
        nets.build("no_such_net", 2)
