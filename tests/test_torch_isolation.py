"""The port stands alone: it imports neither jax nor any `ozone_tpu` module,
and its entry points refuse to run on a CUDA device that is not there."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_imports_no_jax_and_no_reference():
    """Every module of the port, the daemons and the CLI included, imports
    without jax, the reference package or grpc (the port's RPC is the
    standard library's)."""
    out = _run("""
        import importlib, pkgutil, sys
        import ozone_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            ozone_tpu_torch.__path__, "ozone_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "grpc" or m.startswith("grpc.")
                     or m == "ozone_tpu" or m.startswith("ozone_tpu."))
        print(len(names), "ozone_tpu_torch.tools.cli" in names,
              "ozone_tpu_torch.net.daemons" in names, bad)
    """)
    count, cli, net, bad = out.split(" ", 3)
    assert int(count) >= 58 and cli == net == "True", out
    assert bad.strip() == "[]", out


@pytest.mark.parametrize("module", [
    "ozone_tpu_torch.codec.service",
    "ozone_tpu_torch.codec.lrc_math",
    "ozone_tpu_torch.storage.scrubber",
    "ozone_tpu_torch.utils.config",
    # the control plane (the minicluster imports every scm/, om/ and
    # client/ module of it), the re-encode and the host CRC32C
    "ozone_tpu_torch.testing.minicluster",
    "ozone_tpu_torch.client.re_encode",
    "ozone_tpu_torch.utils.checksum",
    # the raw coder SPI, freon and the reconstruction storm
    "ozone_tpu_torch.codec",
    "ozone_tpu_torch.codec.registry",
    "ozone_tpu_torch.codec.torch_coder",
    "ozone_tpu_torch.codec.cpp_coder",
    "ozone_tpu_torch.codec.numpy_coder",
    "ozone_tpu_torch.client.reconstruction",
    "ozone_tpu_torch.tools.freon",
    # the daemon cluster: the RPC, the services, the daemons and the CLI
    "ozone_tpu_torch.net.wire",
    "ozone_tpu_torch.net.rpc",
    "ozone_tpu_torch.net.dn_service",
    "ozone_tpu_torch.net.scm_service",
    "ozone_tpu_torch.net.om_service",
    "ozone_tpu_torch.net.daemons",
    "ozone_tpu_torch.tools.cli",
    "ozone_tpu_torch.tools.__main__",
    # the native chunk datapath: the pooled leases, the sidecar, the client
    "ozone_tpu_torch.codec.hostmem",
    "ozone_tpu_torch.storage.fast_datapath",
    "ozone_tpu_torch.client.native_dn",
])
def test_slice_modules_import_alone_without_jax(module):
    """Each entry module of the codec-service, LRC, scrubber and
    control-plane slices, imported on its own, pulls in neither jax nor
    the reference package, and importing the service starts no dispatcher
    thread."""
    out = _run(f"""
        import importlib, sys, threading
        importlib.import_module("{module}")
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "grpc" or m.startswith("grpc.")
                     or m == "ozone_tpu" or m.startswith("ozone_tpu."))
        print(bad, [t.name for t in threading.enumerate()
                    if t.name == "codec-service"])
    """)
    assert out.strip() == "[] []", out


def test_light_cli_verbs_import_no_torch():
    """The CLI's namespace and admin verbs, and the remote OM and SCM
    clients under them, start without importing torch."""
    out = _run("""
        import sys
        from ozone_tpu_torch.tools import cli
        from ozone_tpu_torch.net.om_service import RemoteOmClient
        from ozone_tpu_torch.net.scm_service import RemoteScmClient
        from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
        cli.build_parser().parse_args(["admin", "status"])
        print("torch" in sys.modules)
    """)
    assert out.strip() == "False"


def test_default_device_raises_without_cuda():
    out = _run("""
        import torch
        from ozone_tpu_torch.codec.api import CoderOptions
        from ozone_tpu_torch.codec.fused import (
            FusedSpec, make_fused_decoder, make_fused_encoder)
        from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
        from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader
        from ozone_tpu_torch.client.ec_writer import BlockGroup, ECKeyWriter
        from ozone_tpu_torch.scm.pipeline import Pipeline, ReplicationConfig
        from ozone_tpu_torch.storage.reconstruction import (
            ECReconstructionCoordinator)
        from ozone_tpu_torch.storage.scrubber import DeviceScrubber
        from ozone_tpu_torch.client.ozone_client import OzoneClient
        from ozone_tpu_torch.client.re_encode import (
            re_encode_key_to_ec, re_encode_xor_key_to_rs)
        from ozone_tpu_torch.codec.fused import make_fused_reencoder
        from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster
        from ozone_tpu_torch.net.daemons import DatanodeDaemon
        import tempfile
        assert not torch.cuda.is_available()
        opts = CoderOptions(3, 2, "rs", cell_size=4096)
        clients = DatanodeClientFactory()
        group = BlockGroup(1, 1, Pipeline(ReplicationConfig.from_ec(opts),
                                          [f"dn{i}" for i in range(5)]), 4096)
        for make in (lambda: make_fused_encoder(FusedSpec(opts)),
                     lambda: make_fused_decoder(FusedSpec(opts), [0, 1, 2], [3]),
                     lambda: ECKeyWriter(opts, None, clients, block_size=4096),
                     lambda: ECBlockGroupReader(group, opts, clients),
                     lambda: ECReconstructionCoordinator(clients),
                     lambda: DeviceScrubber(),
                     lambda: make_fused_reencoder(FusedSpec(opts), 1),
                     lambda: OzoneClient(None, clients),
                     lambda: MiniOzoneCluster(tempfile.mkdtemp()),
                     lambda: DatanodeDaemon(tempfile.mkdtemp(), "dn0",
                                            "127.0.0.1:1"),
                     lambda: re_encode_key_to_ec(None, clients, "v", "b", "k"),
                     lambda: re_encode_xor_key_to_rs(None, clients, "v", "b",
                                                     "k")):
            try:
                make()
            except RuntimeError as e:
                assert "CUDA" in str(e), e
            else:
                raise AssertionError("no error without CUDA")
        print("ok")
    """)
    assert out.strip() == "ok"


def test_coder_spi_entry_points_raise_without_cuda():
    """The torch coders, the storm and the registry's torch backend take
    the card by default and raise without it; the registry then falls
    back at construction to the host coders."""
    out = _run("""
        import torch
        from ozone_tpu_torch.codec import CoderOptions, create_encoder
        from ozone_tpu_torch.codec import torch_coder
        from ozone_tpu_torch.client.reconstruction import ReconstructionStorm
        from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
        assert not torch.cuda.is_available()
        rs, xor = CoderOptions.parse("rs-6-3"), CoderOptions.parse("xor-6-1")
        for make in (lambda: torch_coder.TorchRSEncoder(rs),
                     lambda: torch_coder.TorchRSDecoder(rs),
                     lambda: torch_coder.TorchXOREncoder(xor),
                     lambda: torch_coder.TorchXORDecoder(xor),
                     lambda: torch_coder.encode_fn(rs),
                     lambda: create_encoder(rs, "torch"),
                     lambda: ReconstructionStorm(None, DatanodeClientFactory())):
            try:
                make()
            except RuntimeError as e:
                assert "CUDA" in str(e), e
            else:
                raise AssertionError("no error without CUDA")
        print(type(create_encoder(rs)).__name__,
              type(create_encoder(xor)).__name__)
    """)
    assert out.split() == ["CppRSEncoder", "NumpyXOREncoder"]


def test_registry_builds_nothing_for_the_card():
    """Creating the registry builds the host GF coder (g++) and neither
    the CUDA kernel nor a CUDA context; importing the codec package
    creates no registry."""
    out = _run("""
        import torch
        import ozone_tpu_torch.codec as codec
        from ozone_tpu_torch import cuda_build
        from ozone_tpu_torch.codec.registry import CodecRegistry
        before = CodecRegistry._instance is None
        CodecRegistry.instance()
        print(before, sorted(cuda_build._libs), torch.cuda.is_initialized())
    """)
    assert out.split() == ["True", "['gf_coder']", "False"]


def test_cuda_build_is_lazy():
    """Importing the kernel's module, the host CRC32C's or the control
    plane compiles nothing and needs no nvcc or g++."""
    out = _run("""
        from ozone_tpu_torch import cuda_build
        from ozone_tpu_torch.codec import fused_kernel
        from ozone_tpu_torch.utils import checksum
        import ozone_tpu_torch.testing.minicluster
        print(len(cuda_build._libs), fused_kernel.launches.count)
    """)
    assert out.split() == ["0", "0"]


@pytest.mark.parametrize("path", ["chip_smoke.py"] + sorted(
    p.relative_to(REPO).as_posix()
    for p in (REPO / "ozone_tpu_torch").rglob("*.py")
    if "_build" not in p.relative_to(REPO).parts))  # build outputs
def test_source_names_no_jax(path):
    text = (REPO / path).read_text()
    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            assert "jax" not in stripped and "ozone_tpu." not in stripped \
                and not stripped.startswith(("import ozone_tpu ", "from ozone_tpu ")), \
                f"{path}: {stripped}"


def test_host_crc_builds_from_the_port_alone(tmp_path):
    """The host CRC32C library compiles from the port's own source with
    SSE4.2 (never from a file under ozone_tpu/), into the port's build
    directory, and its probe reports the hardware CRC."""
    out = _run("""
        from ozone_tpu_torch import cuda_build
        from ozone_tpu_torch.utils import checksum
        src, so = cuda_build._target("host_crc32c")
        cmd = cuda_build._command(src)
        print(src.relative_to(cuda_build.PKG).as_posix(),
              so.parent == cuda_build.BUILD, "-msse4.2" in cmd,
              any("ozone_tpu/" in str(a) for a in cmd),
              checksum.route(), checksum.native_probe() >= 1)
    """)
    assert out.split() == ["csrc/host_crc32c.cpp", "True", "True", "False",
                           "native", "True"]
