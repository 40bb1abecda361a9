"""`correct` comes out false when the timed path is broken underneath, and
true when it is not: whole runs on the CPU at a small size, the harness's
look for a card skipped (`run_cell(device="cpu")`), each fault planted in
the program where the answer is produced. The control (the program's own
CRC32 path in place of the configured CRC32C) fails too; on the card the
same control runs at the cells' own sizes (`tools/control.py`)."""

from __future__ import annotations

import pytest
import torch

from portbench.harness import cell as cell_mod
from portbench.tests.conftest import small_cell

SEED = 2_718_281_828
CODEC_CELLS = [("rs-6-3-1024k", "encode_closed"),
               ("rs-10-4-1024k", "decode_closed2")]


def _run(cell, seconds=1.0):
    return cell_mod.run_cell(cell, SEED, seconds, False, device="cpu")


def _altered(out, crcs, batch):
    out = out.clone()
    out[0, 0, 0] ^= 1  # one byte of one answer
    return out, crcs


def _half_batch(out, crcs, batch):
    # the second half of the stripes left out: their answers are zeros
    out, crcs = out.clone(), crcs.clone()
    half = out.shape[0] // 2
    out[half:] = 0
    crcs[half:] = 0
    return out, crcs


def _unchanged(out, crcs, batch):
    # the step hands back what it was given (its input rows as answers)
    b = torch.as_tensor(batch)[:, :out.shape[1]]
    return b.clone().to(out.device), crcs


FAULTS = {"altered": _altered, "half_batch": _half_batch,
          "unchanged": _unchanged}


def _plant(monkeypatch, fault):
    from ozone_tpu_torch.codec import fused

    for name in ("make_fused_encoder", "make_fused_decoder"):
        real = getattr(fused, name)

        def make(*a, _real=real, **k):
            fn = _real(*a, **k)
            return lambda batch: fault(*fn(batch), batch)

        monkeypatch.setattr(fused, name, make)


@pytest.mark.parametrize("config,traffic", CODEC_CELLS)
def test_sound_run_is_correct(config, traffic, cpu_threads):
    res = _run(small_cell(config, traffic))
    assert res["correct"], res["checks"]
    assert res["checks"]["answers_compared"]["value"] >= 2


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("config,traffic", CODEC_CELLS)
def test_planted_fault_is_not_correct(config, traffic, fault, monkeypatch,
                                      cpu_threads):
    _plant(monkeypatch, FAULTS[fault])
    res = _run(small_cell(config, traffic))
    assert not res["correct"], res["checks"]
    assert res["checks"]["unit_stripes_wrong"]["value"] > 0


@pytest.mark.parametrize("config,traffic", CODEC_CELLS)
def test_control_crc32_is_not_correct(config, traffic, cpu_threads):
    cell = small_cell(config, traffic)
    cell.config["checksum"] = "CRC32"
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["crc_words_wrong"]["value"] > 0
    assert res["checks"]["unit_stripes_wrong"]["value"] == 0


# the served-path cells (measured, not in BENCHMARK.json: PERF.md says why)
SERVED = [("rs-6-3-1024k", "put_poisson"), ("rs-10-4-1024k", "get_degraded2"),
          ("rs-10-4-1024k", "get_mostly")]


@pytest.mark.parametrize("config,traffic", SERVED)
def test_served_sound_run_is_correct(config, traffic, cpu_threads):
    res = _run(small_cell(config, traffic), seconds=1.5)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0


def test_put_whose_chunks_never_reach_the_disk_is_not_correct(
        monkeypatch, cpu_threads):
    from ozone_tpu_torch.storage.chunk_store import FilePerBlockStore

    real = FilePerBlockStore.write_chunk

    def dropped(self, block_id, info, data, *a, **k):
        # acknowledged, but the stored cell keeps its old (zero) bytes
        return real(self, block_id, info, bytes(len(memoryview(data).cast("B"))), *a, **k)

    monkeypatch.setattr(FilePerBlockStore, "write_chunk", dropped)
    res = _run(small_cell("rs-6-3-1024k", "put_poisson"), seconds=1.5)
    assert not res["correct"]
    assert res["checks"]["cells_wrong"]["value"] > 0


def test_get_with_an_altered_byte_is_not_correct(monkeypatch, cpu_threads):
    from ozone_tpu_torch.client.ozone_client import OzoneBucket

    real = OzoneBucket.read_key

    def altered(self, key):
        out = real(self, key).copy()
        out[-1] ^= 0x80
        return out

    monkeypatch.setattr(OzoneBucket, "read_key", altered)
    res = _run(small_cell("rs-10-4-1024k", "get_degraded2"), seconds=1.5)
    assert not res["correct"]
    assert res["checks"]["get_bytes_wrong"]["value"] > 0
