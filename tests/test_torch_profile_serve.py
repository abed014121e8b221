"""The serving profiler (``repro_torch.launch.profile_serve``) files the
device time of each kernel under its wrapper's row by the kernel's
demangled name.  The decode bodies are templates on an addressor, so
the row of an instance follows from the number each C entry point of
``csrc/h1d_decode.cu`` launches it with: here, for every entry point,
the name of the instance it launches maps to its wrapper, read from this
tree's source, so a renumbered addressor cannot move a kernel's time to
another row or to "other"."""
import re

import pytest

from repro_torch.kernels import _build
from repro_torch.launch import profile_serve as ps

WRAPPERS = {"h1d_decode_attend": "decode_attend_fused",
            "h1d_decode_attend_paged": "decode_attend_paged",
            "h1d_decode_attend_paged_quant": "decode_attend_paged_quant",
            "h1d_decode_attend_partial": "decode_attend_partial",
            "h1d_update_cache": "update_cache_fused",
            "h1d_update_cache_paged": "update_cache_paged",
            "h1d_update_cache_partial": "update_cache_partial"}


#: the cache elements each decode body is instantiated for
ELEMS = ("float", "__nv_bfloat16")


def _launches():
    """(body, addressor) that each C entry point launches."""
    src = (_build.CSRC / "h1d_decode.cu").read_text()
    consts = {n: int(v) for n, v in re.findall(r"(ADDR_\w+) = (\d+)", src)}
    out = {}
    for fn, body in re.findall(r'extern "C" int (h1d_\w+)\((.*?)\n}\n', src,
                               re.S):
        m = re.search(r"launch_(staged|chain)<(ADDR_\w+)>", body)
        if m:
            out[fn] = (m.group(1), consts[m.group(2)])
    return out


def test_every_addressed_entry_point_is_known():
    assert sorted(_launches()) == sorted(WRAPPERS)
    # one addressor a body and entry point
    for body in ("staged", "chain"):
        addr = [a for b, a in _launches().values() if b == body]
        assert len(addr) == len(set(addr))


@pytest.mark.parametrize("entry", sorted(WRAPPERS))
def test_kernel_instance_maps_to_its_wrapper(entry):
    body, addr = _launches()[entry]
    if body == "staged":
        names = [f"void (anonymous namespace)::attend_staged_kernel<{addr}, "
                 f"{vw}, {e}>(int const*, int const*, int const*, float "
                 f"const*, float*, float*, float*, int, int, int, int, int, "
                 f"float, int, (anonymous namespace)::AttendPlan, (anonymous "
                 f"namespace)::Levels)" for vw in (1, 4) for e in ELEMS]
    else:
        names = [f"void (anonymous namespace)::update_chain_kernel<{addr}, "
                 f"{e}>(float const*, float const*, int const*, int const*, "
                 f"int const*, (anonymous namespace)::MutLevels, int, int, "
                 f"int, int, int, {e}*, {e}*)" for e in ELEMS]
    for name in names:
        assert ps._group(name) == WRAPPERS[entry], name


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::update_cache_quant_kernel<2>(float const*"
     ", float const*, int const*, int const*, (anonymous namespace)::"
     "MutLevels, int, int, int, int)", "update_cache_paged_quant"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8", "matmul"),
    ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT", "matmul"),
    ("(anonymous namespace)::band_stream_kernel(float const*, float const*"
     ", float const*, float const*, float*, float*, float*, int, int, int, "
     "int, int, int, int)", "band_attention_fwd[l0_causal_stream]"),
    ("(anonymous namespace)::stream_dq_kernel(float const*, float const*, "
     "float const*, float const*, float const*, float const*, float const*"
     ", float const*, float const*, float const*, float*, float*, int, int,"
     " int, int, int, int, int)", "band_attention_bwd[l0_causal_stream]"),
    ("(anonymous namespace)::stream_dkvw_kernel(float const*, float const*"
     ", float const*, float const*, float const*, float const*, float "
     "const*, float const*, float*, float*, float*, int, int, int, int, "
     "int, int, int)", "band_attention_bwd[l0_causal_stream]"),
    ("void at::native::vectorized_elementwise_kernel<4>(int, "
     "at::native::CUDAFunctor_add<float>)", "other")])
def test_other_kernels_group(name, group):
    assert ps._group(name) == group


def _event(name, kernels=(), children=(), seq=-1, cpu=True):
    """A stand-in for the profiler's ``FunctionEvent``: name, device type,
    kernels (``Kernel(name, device, duration)``), children, sequence
    number."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Kernel
    return SimpleNamespace(
        name=name, sequence_nr=seq, cpu_children=list(children),
        device_type=DeviceType.CPU if cpu else DeviceType.CUDA,
        kernels=[Kernel(k, 0, us) for k, us in kernels])


GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x32"
ELEM = ("void at::native::vectorized_elementwise_kernel<4>(int, "
        "at::native::CUDAFunctor_add<float>)")


def test_moe_range_takes_its_kernels_and_their_backward():
    """Kernels launched by ops inside a ``moe`` range (a product, a
    gather) and by the backward of those ops go to the group ``moe``, by
    the group they would otherwise join; the same kinds of kernels
    outside the range, and the backward of other ops, do not."""
    bmm = _event("aten::bmm", [(GEMM, 30.0)], seq=7)
    gather = _event("aten::gather", [(ELEM, 5.0)], seq=8)
    moe = _event("moe", children=[_event("aten::matmul", children=[bmm]),
                                  gather])
    other = _event("aten::mm", [(GEMM, 100.0)], seq=9)
    back = _event("autograd::engine::evaluate_function: BmmBackward0",
                  children=[_event("BmmBackward0", children=[_event(
                      "aten::bmm", [(GEMM, 40.0), (GEMM, 20.0)])])], seq=7)
    back_other = _event("autograd::engine::evaluate_function: MmBackward0",
                        children=[_event("aten::mm", [(GEMM, 200.0)])],
                        seq=9)
    stream = _event("moe", [(ELEM, 999.0)], cpu=False)   # the GPU span
    got = ps.range_device_us([moe, bmm, gather, other, back, back_other,
                              stream], ps.MOE_RANGE)
    assert dict(got) == {"matmul": 90.0, "other": 5.0}


def test_no_range_moves_nothing():
    """A dense model's events hold no ``moe`` range: nothing moves."""
    evts = [_event("aten::mm", [(GEMM, 10.0)], seq=1),
            _event("autograd::engine::evaluate_function: MmBackward0",
                   children=[_event("aten::mm", [(GEMM, 20.0)])], seq=1)]
    assert dict(ps.range_device_us(evts, ps.MOE_RANGE)) == {}


def test_ssd_range_is_a_group_of_its_own():
    """An ``ssd`` range (the Mamba2 SSD core) takes its kernels and their
    backward as ``moe`` does, and neither range takes the other's."""
    assert ps.RANGES == ("moe", "ssd", "xattn")
    ein = _event("aten::bmm", [(GEMM, 12.0)], seq=3)
    scan = _event("aten::add", [(ELEM, 2.0)], seq=4)
    ssd = _event("ssd", children=[_event("aten::einsum", children=[ein]),
                                  scan])
    back = _event("autograd::engine::evaluate_function: BmmBackward0",
                  children=[_event("aten::bmm", [(GEMM, 7.0)])], seq=3)
    moe = _event("moe", children=[_event("aten::mm", [(GEMM, 50.0)],
                                         seq=5)])
    evts = [ssd, ein, scan, back, moe]
    assert dict(ps.range_device_us(evts, "ssd")) == {"matmul": 19.0,
                                                     "other": 2.0}
    assert dict(ps.range_device_us(evts, "moe")) == {"matmul": 50.0}


def test_xattn_range_is_a_group_of_its_own():
    """The encoder-decoder's ``xattn`` range (its cross-attention: the
    memory's projection, the queries' and the dense attention) takes its
    kernels and their backward; a band kernel outside it stays its
    wrapper's, and neither ``ssd`` nor ``moe`` takes any of it."""
    proj = _event("aten::mm", [(GEMM, 8.0)], seq=11)
    soft = _event("aten::exp", [(ELEM, 3.0)], seq=12)
    xattn = _event("xattn", children=[proj, soft])
    band = _event("h1d_band_fwd", [(
        "void (anonymous namespace)::band_fwd_kernel<1>(float const*)",
        4.0)])
    back = _event("autograd::engine::evaluate_function: ExpBackward0",
                  children=[_event("aten::mul", [(ELEM, 1.5)])], seq=12)
    evts = [xattn, proj, soft, band, back]
    assert dict(ps.range_device_us(evts, "xattn")) == {"matmul": 8.0,
                                                       "other": 4.5}
    assert dict(ps.range_device_us(evts, "ssd")) == {}
    assert dict(ps.range_device_us(evts, "moe")) == {}
    assert ps._group(band.kernels[0].name) == "band_attention_fwd"
