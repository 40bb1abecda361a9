"""The port's raw erasure-coder SPI against `ozone_tpu`'s, on the CPU.

The port's numpy, cpp and torch coders (the torch coder with
device="cpu": the kernel's plain PyTorch versions) are held byte-exact
against `ozone_tpu`'s numpy coders and, for RS and XOR, its jax coders
on the same seeded inputs: every schema at cells of 1, 100, 4096 and
4097 bytes, batched and not, decoders fed [B, C] units; every erasure
pattern up to p for RS(3,2) and RS(6,3). Then the registry (priority
order, backend selection, construction-time fallback, the device
keyword), the decoders' input validation with the reference's messages,
and `CoderOptions` parsing. `ozone_tpu`'s cpp coder and registry
instance are not used as oracles: both build the reference's native
library in place.
"""

import itertools

import numpy as np
import pytest
import torch

from ozone_tpu.codec import api as j_api
from ozone_tpu.codec import jax_coder as j_jax
from ozone_tpu.codec import numpy_coder as j_np
from ozone_tpu.codec.bitlin import expand_coding_matrix as j_expand
from ozone_tpu_torch.codec import (
    CodecRegistry,
    CoderOptions,
    cpp_coder,
    create_decoder,
    create_encoder,
    numpy_coder,
    registry,
    torch_coder,
)
from ozone_tpu_torch.codec import api


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain PyTorch versions run at test sizes on one thread: the
    suite runs in several worker processes on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCHEMAS = ["rs-3-2", "rs-6-3", "rs-10-4", "xor-3-1", "xor-6-1",
           "lrc-12-2-2", "dummy-3-2"]
CELLS = [1, 100, 4096, 4097]

#: the reference's coder classes per family: (encoder, decoder)
REF_NUMPY = {
    "rs": (j_np.NumpyRSEncoder, j_np.NumpyRSDecoder),
    "xor": (j_np.NumpyXOREncoder, j_np.NumpyXORDecoder),
    "lrc": (j_np.NumpyLRCEncoder, j_np.NumpyLRCDecoder),
    "dummy": (j_np.DummyEncoder, j_np.DummyDecoder),
}
REF_JAX = {
    "rs": (j_jax.JaxRSEncoder, j_jax.JaxRSDecoder),
    "xor": (j_jax.JaxXOREncoder, j_jax.JaxXORDecoder),
}
PORT = {
    "rs": {"numpy": (numpy_coder.NumpyRSEncoder, numpy_coder.NumpyRSDecoder),
           "cpp": (cpp_coder.CppRSEncoder, cpp_coder.CppRSDecoder),
           "torch": (torch_coder.TorchRSEncoder, torch_coder.TorchRSDecoder)},
    "xor": {"numpy": (numpy_coder.NumpyXOREncoder, numpy_coder.NumpyXORDecoder),
            "torch": (torch_coder.TorchXOREncoder, torch_coder.TorchXORDecoder)},
    "lrc": {"numpy": (numpy_coder.NumpyLRCEncoder, numpy_coder.NumpyLRCDecoder)},
    "dummy": {"numpy": (numpy_coder.DummyEncoder, numpy_coder.DummyDecoder)},
}


def _opts(schema: str, cell: int):
    return (CoderOptions.parse(f"{schema}-{cell}"),
            j_api.CoderOptions.parse(f"{schema}-{cell}"))


def _make(cls, opts, backend):
    return cls(opts, device="cpu") if backend == "torch" else cls(opts)


def _port_coders(opts, which: int):
    return {be: _make(pair[which], opts, be)
            for be, pair in PORT[opts.codec].items()}


def _ref_coders(ropts, which: int):
    out = {"ref-numpy": REF_NUMPY[ropts.codec][which](ropts)}
    if ropts.codec in REF_JAX:
        out["ref-jax"] = REF_JAX[ropts.codec][which](ropts)
    return out


def _data(opts, cell, batched, seed):
    rng = np.random.default_rng(seed)
    shape = (3, opts.data_units, cell) if batched else (opts.data_units, cell)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _codeword(opts, data):
    """Data and the reference numpy coder's parity, [B, k+p, C]."""
    ropts = j_api.CoderOptions.parse(str(opts))
    parity = REF_NUMPY[opts.codec][0](ropts).encode(data)
    return np.concatenate([data, parity], axis=-2)


# ------------------------------------------------------------------ options
@pytest.mark.parametrize("text", ["dummy-3-2-4096", "rs-6-3-1024k", "xor-6-1",
                                  "lrc-12-2-2-4096"])
def test_coder_options_parse_and_str_match_reference(text):
    got, want = CoderOptions.parse(text), j_api.CoderOptions.parse(text)
    assert str(got) == str(want)
    assert (got.data_units, got.parity_units, got.codec, got.cell_size,
            got.local_groups) == (want.data_units, want.parity_units,
                                  want.codec, want.cell_size,
                                  want.local_groups)


@pytest.mark.parametrize("text", ["foo-6-3", "rs-6", "lrc-12-2"])
def test_coder_options_parse_errors_match_reference(text):
    with pytest.raises(ValueError) as got:
        CoderOptions.parse(text)
    with pytest.raises(ValueError) as want:
        j_api.CoderOptions.parse(text)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------- encode / decode
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "unbatched"])
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("schema", SCHEMAS)
def test_encode_matches_reference(schema, cell, batched):
    opts, ropts = _opts(schema, cell)
    data = _data(opts, cell, batched, seed=cell + len(schema))
    want = {name: c.encode(data) for name, c in _ref_coders(ropts, 0).items()}
    ref = want["ref-numpy"]
    assert ref.shape == data.shape[:-2] + (opts.parity_units, cell)
    for name, w in want.items():
        assert np.array_equal(w, ref), name
    for name, coder in _port_coders(opts, 0).items():
        got = coder.encode(data)
        assert got.dtype == np.uint8 and got.shape == ref.shape, name
        assert np.array_equal(got, ref), name


#: one erasure pattern per schema for the cell-size sweep
PATTERNS = {"rs-3-2": [0, 4], "rs-6-3": [1, 2, 7], "rs-10-4": [0, 3, 11, 13],
            "xor-3-1": [1], "xor-6-1": [6], "lrc-12-2-2": [0, 1, 12],
            "dummy-3-2": [2]}


def _decode_all(opts, ropts, units, erased, batched):
    """{coder name: decoded units} over the reference and port coders,
    inputs as [B, C] (or [C]) per unit with None holes."""
    inputs = [None if i in erased else
              (units[:, i] if batched else units[i])
              for i in range(opts.all_units)]
    out = {name: c.decode(inputs, erased)
           for name, c in _ref_coders(ropts, 1).items()}
    out.update({name: c.decode(inputs, erased)
                for name, c in _port_coders(opts, 1).items()})
    return out


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "unbatched"])
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("schema", SCHEMAS)
def test_decode_matches_reference(schema, cell, batched):
    opts, ropts = _opts(schema, cell)
    data = _data(opts, cell, batched, seed=7 * cell + len(schema))
    units = _codeword(opts, data)
    erased = PATTERNS[schema]
    got = _decode_all(opts, ropts, units, erased, batched)
    ref = got["ref-numpy"]
    assert ref.shape == data.shape[:-2] + (len(erased), cell)
    for name, out in got.items():
        assert out.dtype == np.uint8 and np.array_equal(out, ref), name
    if opts.codec != "dummy":
        want = units[:, erased] if batched else units[erased]
        assert np.array_equal(ref, want)


def _patterns(schema):
    opts = CoderOptions.parse(schema)
    n = opts.all_units
    return [(schema, list(e)) for r in range(1, opts.parity_units + 1)
            for e in itertools.combinations(range(n), r)]


@pytest.mark.parametrize("schema,erased", _patterns("rs-3-2") + _patterns("rs-6-3"),
                         ids=lambda v: v if isinstance(v, str)
                         else "-".join(map(str, v)))
def test_every_erasure_pattern_matches_reference(schema, erased):
    opts, ropts = _opts(schema, 100)
    data = _data(opts, 100, True, seed=sum(erased) + 31 * len(erased))
    units = _codeword(opts, data)
    got = _decode_all(opts, ropts, units, erased, batched=True)
    assert set(got) == {"ref-numpy", "ref-jax", "numpy", "cpp", "torch"}
    for name, out in got.items():
        assert np.array_equal(out, units[:, erased]), name


def test_decoder_hands_contiguous_units_to_the_torch_coder():
    """[B, C] inputs reach do_decode as a strided [B, k, C] view; the
    torch coder copies it to contiguous rows, which the kernel takes."""
    opts, _ = _opts("rs-6-3", 4096)
    units = _codeword(opts, _data(opts, 4096, True, seed=3))
    inputs = [None if i in (0, 1) else units[:, i] for i in range(9)]
    seen = []
    dec = torch_coder.TorchRSDecoder(opts, device="cpu")
    do_decode = dec.do_decode

    def spy(valid_data, valid, erased):
        seen.append(valid_data.flags["C_CONTIGUOUS"])
        return do_decode(valid_data, valid, erased)

    dec.do_decode = spy
    assert np.array_equal(dec.decode(inputs, [0, 1]), units[:, [0, 1]])
    assert seen == [False]


# ------------------------------------------------- device functions (plain)
@pytest.mark.parametrize("cell", CELLS)
def test_gf_apply_and_xor_reduce_match_jax_programs(cell):
    rng = np.random.default_rng(cell)
    data = rng.integers(0, 256, (2, 6, cell), dtype=np.uint8)
    matrix = rng.integers(0, 256, (4, 6), dtype=np.uint8)
    want = np.asarray(j_jax.gf_apply(data, j_expand(matrix).astype(np.int8)))
    got = torch_coder.gf_apply(torch.from_numpy(data), torch.from_numpy(matrix))
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(j_jax._xor_reduce_jit(data))
    assert np.array_equal(torch_coder.xor_reduce(torch.from_numpy(data)).numpy(),
                          want)
    assert np.array_equal(
        torch_coder.xor_reduce_plain(torch.from_numpy(data)).numpy(), want)


def test_encode_fn_matches_jax_encode_fn():
    opts, ropts = _opts("rs-6-3", 4096)
    data = _data(opts, 4096, True, seed=11)
    fn, matrix = torch_coder.encode_fn(opts, device="cpu")
    jfn, a_bits = j_jax.encode_fn(ropts)
    assert matrix.shape == (3, 6) and matrix.dtype == torch.uint8
    assert np.array_equal(fn(torch.from_numpy(data), matrix).numpy(),
                          np.asarray(jfn(data, a_bits)))


@pytest.mark.parametrize("cell,slice_", [(1, 1), (100, 100), (4096, 4096),
                                         (4097, 4097), (1 << 20, 4096),
                                         (6 * 1000, 2000), (3 * 4097, 3 * 4097)])
def test_apply_slice_splits_cells_into_whole_vectors(cell, slice_):
    assert torch_coder.apply_slice(cell) == slice_
    assert cell % torch_coder.apply_slice(cell) == 0


def test_no_cpu_launch_is_counted():
    before = (torch_coder.apply_launches.count, torch_coder.xor_launches.count)
    t = torch.zeros((1, 3, 64), dtype=torch.uint8)
    torch_coder.gf_apply(t, torch.ones((2, 3), dtype=torch.uint8))
    torch_coder.xor_reduce(t)
    assert (torch_coder.apply_launches.count,
            torch_coder.xor_launches.count) == before


# ----------------------------------------------------------------- registry
def test_registry_order_and_selection():
    reg = CodecRegistry.instance()
    assert reg.backends("rs") == ["torch", "cpp", "numpy"]
    assert reg.backends("xor") == ["torch", "numpy"]
    assert reg.backends("lrc") == ["numpy"]
    assert reg.backends("dummy") == ["numpy"]
    opts = CoderOptions.parse("rs-6-3-4096")
    assert isinstance(create_encoder(opts, "numpy"), numpy_coder.NumpyRSEncoder)
    assert isinstance(create_decoder(opts, "cpp"), cpp_coder.CppRSDecoder)
    enc = create_encoder(opts, "torch", device="cpu")
    assert isinstance(enc, torch_coder.TorchRSEncoder)
    assert enc.device == torch.device("cpu")
    # device reaches the torch factory only
    assert isinstance(create_decoder(opts, "numpy", device="cpu"),
                      numpy_coder.NumpyRSDecoder)
    assert isinstance(create_encoder(CoderOptions.parse("xor-6-1-4096"),
                                     device="cpu"), torch_coder.TorchXOREncoder)
    assert isinstance(create_decoder(CoderOptions.parse("lrc-12-2-2-4096")),
                      numpy_coder.NumpyLRCDecoder)


def test_default_rs_coder_falls_back_at_construction_without_cuda():
    """With no card, the torch constructor raises and the registry takes
    the next backend; naming the torch backend alone raises."""
    assert not torch.cuda.is_available()
    opts = CoderOptions.parse("rs-6-3-4096")
    assert isinstance(create_encoder(opts), cpp_coder.CppRSEncoder)
    assert isinstance(create_decoder(CoderOptions.parse("xor-6-1-4096")),
                      numpy_coder.NumpyXORDecoder)
    with pytest.raises(RuntimeError, match="all backends failed for rs encoder: "
                       "torch: CUDA is not available"):
        create_encoder(opts, "torch")


def test_registry_errors_match_reference():
    from ozone_tpu.codec.registry import CodecRegistry as JRegistry

    reg, jreg = CodecRegistry(), JRegistry()  # neither with its defaults
    opts = CoderOptions.parse("rs-6-3-4096")
    ropts = j_api.CoderOptions.parse("rs-6-3-4096")
    for r, o in ((reg, opts), (jreg, ropts)):
        r.register("rs", "numpy", 10, lambda op: None, lambda op: None)
    msgs = []
    for r, o in ((reg, opts), (jreg, ropts)):
        with pytest.raises(ValueError) as e1:
            r.create_encoder(o, "nope")
        with pytest.raises(ValueError) as e2:
            r.create_decoder(type(o)(3, 1, "xor", 4096))
        msgs.append((str(e1.value), str(e2.value)))
    assert msgs[0] == msgs[1]
    assert msgs[0][0] == "backend 'nope' not registered for 'rs'"


def test_registry_priority_and_fallback_order():
    reg = CodecRegistry()
    calls = []

    def failing(name):
        def make(opts):
            calls.append(name)
            raise RuntimeError(f"{name} down")
        return make

    reg.register("rs", "low", 1, failing("low"), failing("low"))
    reg.register("rs", "high", 99, failing("high"), failing("high"))
    reg.register("rs", "mid", 50, numpy_coder.NumpyRSEncoder,
                 numpy_coder.NumpyRSDecoder)
    assert reg.backends("rs") == ["high", "mid", "low"]
    enc = reg.create_encoder(CoderOptions.parse("rs-3-2-4096"))
    assert isinstance(enc, numpy_coder.NumpyRSEncoder) and calls == ["high"]
    calls.clear()
    failing_only = CodecRegistry()
    for name, prio in (("low", 1), ("high", 99)):
        failing_only.register("rs", name, prio, failing(name), failing(name))
    with pytest.raises(RuntimeError, match="all backends failed for rs decoder: "
                       "high: high down; low: low down"):
        failing_only.create_decoder(CoderOptions.parse("rs-3-2-4096"))
    assert calls == ["high", "low"]


def test_known_families_follow_the_live_registry(monkeypatch):
    monkeypatch.setattr(CodecRegistry, "_instance", None)
    assert registry.known_families() == ("dummy", "lrc", "rs", "xor")
    with pytest.raises(ValueError, match="unknown EC codec 'toy'"):
        CoderOptions.parse("toy-3-2")
    reg = CodecRegistry()
    reg.register("toy", "numpy", 10, numpy_coder.DummyEncoder,
                 numpy_coder.DummyDecoder)
    monkeypatch.setattr(CodecRegistry, "_instance", reg)
    assert registry.known_families() == ("dummy", "lrc", "rs", "toy", "xor")
    assert str(CoderOptions.parse("toy-3-2-4096")) == "toy-3-2-4k"


def test_torch_coder_refuses_more_rows_than_the_kernel_writes():
    opts = CoderOptions(8, 17, "rs", 4096)
    with pytest.raises(ValueError, match="at most 16 rows"):
        torch_coder.TorchRSEncoder(opts, device="cpu")
    assert isinstance(create_encoder(opts, device="cpu"), cpp_coder.CppRSEncoder)


def test_cpp_probe_and_crc_route():
    """The GF coder builds from the port's own source with the reference's
    flags, and its CRC32C is the host CRC32C library's."""
    from ozone_tpu_torch import cuda_build
    from ozone_tpu_torch.utils import checksum

    src, so = cuda_build._target("gf_coder")
    cmd = cuda_build._command(src)
    assert src.name == "gf_coder.cpp" and so.parent == cuda_build.BUILD
    assert {"-O3", "-march=native", "-pthread"} <= set(cmd)
    assert cpp_coder.probe() in (0, 2)
    data = np.random.default_rng(1).integers(0, 256, 10_000, dtype=np.uint8)
    assert cpp_coder.crc32c_native(data) == checksum.crc32c(data)
    assert cpp_coder.crc32c_native(data, 77) == checksum.crc32c(data, 77)


@pytest.mark.parametrize("threads", [0, 1, 3])
def test_cpp_apply_threads_match(threads):
    opts = CoderOptions.parse("rs-6-3-4096")
    data = _data(opts, 4096, True, seed=5)
    tables = cpp_coder._nibble_tables(numpy_coder.rs_math.parity_matrix(6, 3))
    got = cpp_coder._apply(cpp_coder.load(), tables, 3, 6, data, threads)
    assert np.array_equal(got, j_np.NumpyRSEncoder(
        j_api.CoderOptions.parse("rs-6-3-4096")).encode(data))


# --------------------------------------------------------------- validation
def _bad_calls(n, unit):
    return {
        "short": ([unit] * (n - 1), [0]),
        "no-erased": ([None] + [unit] * (n - 1), []),
        "out-of-range": ([None] + [unit] * (n - 1), [n]),
        "erased-present": ([unit] * n, [0]),
        "too-few": ([None] * 3 + [unit] * (n - 3), [0, 1, 2]),
        "bad-rank": ([None] + [unit[None, None]] * (n - 1), [0]),
    }


@pytest.mark.parametrize("case", list(_bad_calls(5, np.zeros(4, np.uint8))))
@pytest.mark.parametrize("backend", ["numpy", "cpp", "torch"])
def test_decoder_validation_matches_reference(backend, case):
    opts, ropts = _opts("rs-3-2", 4)
    unit = np.zeros(4, dtype=np.uint8)
    inputs, erased = _bad_calls(5, unit)[case]
    dec = _make(PORT["rs"][backend][1], opts, backend)
    with pytest.raises(ValueError) as got:
        dec.decode(inputs, erased)
    with pytest.raises(ValueError) as want:
        j_np.NumpyRSDecoder(ropts).decode(inputs, erased)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("data", [
    np.zeros((3, 8), dtype=np.int32), np.zeros((2, 8), dtype=np.uint8),
    np.zeros((1, 2, 3, 8), dtype=np.uint8), np.zeros((1, 4, 8), dtype=np.uint8),
], ids=["dtype", "units", "rank", "batched-units"])
def test_encoder_validation_matches_reference(data):
    opts, ropts = _opts("rs-3-2", 8)
    errs = []
    for enc in (torch_coder.TorchRSEncoder(opts, device="cpu"),
                numpy_coder.NumpyRSEncoder(opts),
                j_np.NumpyRSEncoder(ropts)):
        with pytest.raises((TypeError, ValueError)) as e:
            enc.encode(data)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1] == errs[2]


def test_xor_and_lrc_decoder_errors_match_reference():
    for schema, erased in (("xor-3-1", [0, 1]),):
        opts, ropts = _opts(schema, 8)
        units = [np.zeros(8, np.uint8)] * opts.all_units
        inputs = [None if i in erased else u for i, u in enumerate(units)]
        msgs = set()
        for dec in (numpy_coder.NumpyXORDecoder(opts),
                    torch_coder.TorchXORDecoder(opts, device="cpu"),
                    j_np.NumpyXORDecoder(ropts)):
            with pytest.raises(ValueError) as e:
                dec.decode(inputs, erased)
            msgs.add(str(e.value))
        assert len(msgs) == 1
    opts, ropts = _opts("lrc-12-2-2", 8)
    inputs = [None] * 5 + [np.zeros(8, np.uint8)] * 11
    with pytest.raises(ValueError) as got:
        numpy_coder.NumpyLRCDecoder(opts).decode(inputs, [0, 1, 2, 3, 4])
    with pytest.raises(ValueError) as want:
        j_np.NumpyLRCDecoder(ropts).decode(inputs, [0, 1, 2, 3, 4])
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="XOR codec supports exactly one"):
        torch_coder.TorchXOREncoder(CoderOptions(3, 2, "xor", 8), device="cpu")


def test_api_module_names():
    assert api.KNOWN_FAMILIES == ("dummy", "lrc", "rs", "xor")
    for name in ("CoderOptions", "RawErasureEncoder", "RawErasureDecoder",
                 "CodecRegistry", "create_encoder", "create_decoder"):
        import ozone_tpu_torch.codec as port_codec
        import ozone_tpu.codec as ref_codec

        assert name in port_codec.__all__ and name in ref_codec.__all__
        assert getattr(port_codec, name) is not None
