"""The port stands alone: it imports neither jax nor any `ozone_tpu` module
(and `cryptography` only where the reference does, inside the functions
of the KMS, the CA and the RPC's revocation check, never at import), and
its entry points refuse to run on a CUDA device that is not there."""

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
    without jax, the reference package, grpc (the port's RPC is the
    standard library's) or cryptography (tokens and ACLs are HMAC and
    JSON)."""
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
                     or m == "cryptography" or m.startswith("cryptography.")
                     or m == "ozone_tpu" or m.startswith("ozone_tpu."))
        print(len(names), "ozone_tpu_torch.tools.cli" in names,
              "ozone_tpu_torch.net.daemons" in names,
              "ozone_tpu_torch.gateway.s3" in names, bad)
    """)
    count, cli, net, gw, bad = out.split(" ", 4)
    assert int(count) >= 72 and cli == net == gw == "True", out
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
    # the S3 gateway: SigV4, admission, the OM's multipart requests
    "ozone_tpu_torch.gateway.s3",
    "ozone_tpu_torch.gateway.s3_auth",
    "ozone_tpu_torch.admission",
    "ozone_tpu_torch.admission.controller",
    "ozone_tpu_torch.admission.bucket",
    "ozone_tpu_torch.admission.shed",
    "ozone_tpu_torch.om.multipart",
    # lifecycle tiering and the small-object path
    "ozone_tpu_torch.lifecycle",
    "ozone_tpu_torch.lifecycle.policy",
    "ozone_tpu_torch.lifecycle.service",
    "ozone_tpu_torch.lifecycle.executor",
    "ozone_tpu_torch.client.slab",
    "ozone_tpu_torch.utils.throttle",
    # consensus and HA: the Raft core, the metadata ring, the pipelines
    "ozone_tpu_torch.consensus",
    "ozone_tpu_torch.consensus.raft",
    "ozone_tpu_torch.consensus.meta_ring",
    "ozone_tpu_torch.net.raft_transport",
    "ozone_tpu_torch.net.ratis_service",
    "ozone_tpu_torch.om.ha",
    "ozone_tpu_torch.om.sharding.leases",
    "ozone_tpu_torch.scm.ha",
    "ozone_tpu_torch.scm.scm_store",
    "ozone_tpu_torch.scm.sequence_id",
    "ozone_tpu_torch.storage.ratis",
    "ozone_tpu_torch.client.ratis_client",
    # the filesystem namespace: FSO, checksums, ofs, HttpFS and CSI
    "ozone_tpu_torch.om.fso",
    "ozone_tpu_torch.client.file_checksum",
    "ozone_tpu_torch.client.libo3fs",
    "ozone_tpu_torch.gateway.fs",
    "ozone_tpu_torch.gateway.httpfs",
    "ozone_tpu_torch.gateway.csi",
    # security: block and container tokens, native ACLs, delegation tokens
    "ozone_tpu_torch.utils.security",
    "ozone_tpu_torch.om.acl",
    "ozone_tpu_torch.om.dtokens",
    # encryption at rest and in transit: the KMS and the CA (their
    # `cryptography` is imported where it is used, never at import)
    "ozone_tpu_torch.utils.kms",
    "ozone_tpu_torch.utils.ca",
    # geo replication: the rules and their S3 XML, the shipper
    "ozone_tpu_torch.replication_geo",
    "ozone_tpu_torch.replication_geo.rules",
    "ozone_tpu_torch.replication_geo.shipper",
    # sharded metadata: the map and its gate, the 2PC, the plane, the
    # router, shardd
    "ozone_tpu_torch.om.sharding",
    "ozone_tpu_torch.om.sharding.shardmap",
    "ozone_tpu_torch.om.sharding.txn",
    "ozone_tpu_torch.om.sharding.plane",
    "ozone_tpu_torch.om.sharding.router",
    "ozone_tpu_torch.tools.shardd",
    # upgrade finalization and the operator's view: layout versions, the
    # audit log and its parser, /prom, insight, the trace collector, Recon
    "ozone_tpu_torch.utils.upgrade",
    "ozone_tpu_torch.utils.audit",
    "ozone_tpu_torch.utils.metrics",
    "ozone_tpu_torch.utils.tracing",
    "ozone_tpu_torch.utils.http_server",
    "ozone_tpu_torch.utils.insight",
    "ozone_tpu_torch.tools.audit_parser",
    "ozone_tpu_torch.recon",
    "ozone_tpu_torch.recon.recon",
    "ozone_tpu_torch.recon.ui",
    # fault injection and the repair tools: partitions and verb rules, the
    # filesystem injector's controller, the chaos harness, ozlint, om_scale
    "ozone_tpu_torch.net.partition",
    "ozone_tpu_torch.testing.fault_injection",
    "ozone_tpu_torch.testing.chaos",
    "ozone_tpu_torch.tools.lint",
    "ozone_tpu_torch.tools.lint.core",
    "ozone_tpu_torch.tools.lint.rules",
    "ozone_tpu_torch.tools.lint.__main__",
    "ozone_tpu_torch.tools.om_scale",
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
                     or m == "cryptography" or m.startswith("cryptography.")
                     or m == "ozone_tpu" or m.startswith("ozone_tpu."))
        print(bad, [t.name for t in threading.enumerate()
                    if t.name == "codec-service"])
    """)
    assert out.strip() == "[] []", out


def test_light_cli_verbs_import_no_torch():
    """The CLI's namespace, `fs`, admin (`admin shards`, `upgrade`,
    `finalizeupgrade`, `reconfig` and `namespace` too), ACL, tenant,
    token, replication, `insight`, `audit`, `trace`, `getconf` and
    `version` verbs, the remote OM and SCM clients under them with the
    shard router, the file checksum, the ofs adapter, the CSI driver,
    the security modules, the geo replication rules and shipper, Recon
    and the observability modules start without importing torch."""
    out = _run("""
        import sys
        from ozone_tpu_torch.tools import cli
        from ozone_tpu_torch.net.om_service import RemoteOmClient
        from ozone_tpu_torch.net.scm_service import RemoteScmClient
        from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
        from ozone_tpu_torch.client.file_checksum import file_checksum
        from ozone_tpu_torch.gateway.fs import RootedOzoneFileSystem
        from ozone_tpu_torch.gateway.csi import CsiServer
        from ozone_tpu_torch.om import fso
        cli.build_parser().parse_args(["admin", "status"])
        cli.build_parser().parse_args(["fs", "ls", "/v/b"])
        cli.build_parser().parse_args(["admin", "om", "list-open-files"])
        cli.build_parser().parse_args(["acl", "bucket", "get", "/v/b"])
        cli.build_parser().parse_args(["tenant", "create", "acme"])
        cli.build_parser().parse_args(["sh", "token", "print"])
        cli.build_parser().parse_args(["replication", "get", "/v/b"])
        cli.build_parser().parse_args(["admin", "shards", "map"])
        for argv in (["admin", "upgrade"], ["admin", "finalizeupgrade"],
                     ["admin", "reconfig", "properties", "--http", "h:1"],
                     ["admin", "namespace", "summary", "/v/b"],
                     ["insight", "logs", "--address", "h:1"],
                     ["audit", "top", "a.log"], ["trace", "show", "t1"],
                     ["getconf"], ["version"]):
            cli.build_parser().parse_args(argv)
        import contextlib, io
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["getconf"]) == 0
            assert cli.main(["version"]) == 0
            assert cli.main(["audit", "top", "no-such.log"]) == 1
        from ozone_tpu_torch.recon import recon, ui
        from ozone_tpu_torch.tools import audit_parser
        from ozone_tpu_torch.utils import (http_server, insight, tracing,
                                           upgrade)
        from ozone_tpu_torch.om.sharding import router, shardmap, txn
        from ozone_tpu_torch.replication_geo import rules, shipper
        from ozone_tpu_torch.om import acl, dtokens
        from ozone_tpu_torch.utils import security
        # fault injection and the operator's repair tools
        from ozone_tpu_torch.net import partition
        from ozone_tpu_torch.testing import fault_injection
        from ozone_tpu_torch.tools import lint, om_scale
        from ozone_tpu_torch.tools.lint import rules
        from ozone_tpu_torch.storage import container, container_packer
        for argv in (["fsck", "--volume", "v"], ["repair", "orphans"],
                     ["repair", "transaction", "--db", "x.db"],
                     ["debug", "container-list", "--root", "r"],
                     ["debug", "verify-replicas", "/v/b/k"],
                     ["insight", "partition", "--dst", "h:2"],
                     ["insight", "delay", "--dst", "h:2", "--seconds", "1"],
                     ["insight", "partitions"]):
            cli.build_parser().parse_args(argv)
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            assert cli.main(["repair", "transaction", "--db", "no.db"]) == 2
            assert cli.main(["debug", "container-list", "--root", "no"]) == 2
        lint.lint_source("x = 1", path="ozone_tpu_torch/net/x.py")
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
        from ozone_tpu_torch.gateway.s3 import S3Gateway
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
                                                     "k"),
                     lambda: S3Gateway(OzoneClient(None, clients))):
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
    # AES (the KMS), x509 (the CA) and the peer certificate's serial (the
    # RPC's revocation check) are `cryptography`'s, as in the reference
    crypto_ok = path in ("ozone_tpu_torch/utils/kms.py",
                         "ozone_tpu_torch/utils/ca.py",
                         "ozone_tpu_torch/net/rpc.py")
    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            assert "jax" not in stripped and "ozone_tpu." not in stripped \
                and (crypto_ok or "cryptography" not in stripped) \
                and not stripped.startswith(("import ozone_tpu ", "from ozone_tpu ")), \
                f"{path}: {stripped}"


def test_secure_mode_and_tde_raise_without_cryptography(tmp_path):
    """No fallback: with `cryptography` missing, a CA, a secure daemon and
    a TDE bucket's first open raise (a plaintext cluster still runs)."""
    out = _run(f"""
        import sys
        sys.modules["cryptography"] = None  # as if not installed
        from pathlib import Path
        from ozone_tpu_torch.net.daemons import ScmOmDaemon
        from ozone_tpu_torch.utils.ca import CertificateAuthority
        root = Path({str(tmp_path)!r})
        seen = []
        for fn in (lambda: CertificateAuthority(root / "ca"),
                   lambda: ScmOmDaemon(root / "s" / "om.db", secure=True,
                                       device="cpu")):
            try:
                fn()
                seen.append("served")
            except RuntimeError as e:
                seen.append("cryptography" in str(e))
        d = ScmOmDaemon(root / "p" / "om.db", device="cpu")
        d.om.create_volume("v")
        d.om.kms_create_key("mk")
        d.om.create_bucket("v", "enc", "rs-3-2-4096", encryption_key="mk")
        try:
            d.om.open_key("v", "enc", "k")
            seen.append("served")
        except ImportError:
            seen.append(True)
        d.om.close()
        print(seen)
    """)
    assert out.strip() == "[True, True, True]", out


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
