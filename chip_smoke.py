#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--kernel-only | --mesh-only | --host-only]

Builds the port's CUDA kernels (nvcc, sm_90a) and its host libraries
(the CRC32C with g++ -msse4.2, the GF coder and the chunk datapath
sidecar with -march=native) from
`ozone_tpu_torch/csrc`, fails unless the host CRC library reports the
SSE4.2 CRC and the GF coder the AVX2 build, holds every kernel against
its plain PyTorch version on the card, in its RS, XOR and LRC encode
forms, its XOR(1)->RS re-encode form, its decode forms (RS, LRC local,
across groups and global), its scrub form (slice CRCs, no coding rows)
and the coder SPI's forms (no CRC rows, below), then drives the
port's main paths, on the shared codec service (the default route) unless
a phase says otherwise:

- four concurrent RS(6,3) key PUTs through `ECKeyWriter` into nine
  in-process datanodes, read back and checked against the source bytes
  and the plain version's parity and CRCs, once on the service and once
  with OZONE_TPU_CODEC_SERVICE=0 (the direct route);
- 32 concurrent small RS(6,3) PUTs (one stripe and a 4 KiB tail each)
  whose tails coalesce in the service;
- RS(10,4) read and repair: two keys PUT into 16 datanodes, read whole
  through `ECBlockGroupReader` healthy (alternately with the datanodes'
  CRC check on the native and on the numpy route), then with two data
  units down
  (whole and ranged), their replicas rebuilt onto two spares by
  `ECReconstructionCoordinator`, and read again through the rebuilt
  replicas with two other units down;
- LRC(12,2,2): two keys PUT into 18 datanodes, read healthy, with one
  unit down (local repair, reading only the lost unit's group), with
  unit 0 down (a short group's local repair over known-zero units), with
  two units of one group down (global decode), and unit 2 rebuilt onto a
  spare from its group;
- the device scrubber over every closed container of those datanodes,
  then over a container with one flipped byte, against the host scan;
- the control plane: a `MiniOzoneCluster` (SCM, OM, 12 datanodes on 3
  racks) takes an XOR(6,1) key, a RATIS/THREE key and a second XOR key
  through `OzoneClient`; the replicated key is re-encoded to RS(6,3), the
  first XOR key with unit 2's datanode down (the fused re-encode), the
  second with its parity's datanode down (a plain encode); every key is
  re-read byte-exact; then one RS datanode dies and the SCM's own
  reconstruction commands rebuild its replicas onto spares;
- freon (`freon_path`): the raw coder SPI's rawcoder_bench (rs-6-3 and
  rs-10-4 on the torch, cpp and numpy coders, xor-6-1 on torch and numpy,
  B=8, 1 MiB cells; torch's outputs equal numpy's); then on a
  `MiniOzoneCluster` of 12 datanodes on 3 racks (rs-6-3-1024k, 16 MiB
  blocks): ockg (48 keys of 16 MiB), ockv, ockrr (64 ranged reads of
  1 MiB), ecrd (64 MiB, 3 rounds), and the reconstruction storm: the
  datanode holding the most closed EC containers (at least 8) dies and
  `ReconstructionStorm.repair_datanode` rebuilds every one, byte-exact;
- the daemon cluster (`daemon_path`): an ScmOmDaemon and 12
  DatanodeDaemons on loopback on 3 racks, each with its native chunk
  datapath sidecar (`csrc/datapath.cpp`), driven through a remote
  OzoneClient: the PUT phase's four keys concurrently over the native
  lane, then again over the RPC lane (GiB/s of each beside the in-process
  rate of the same keys), a GET over each lane and through in-process
  clients, a degraded GET with two holders' servers and sidecars stopped,
  an admin close of the containers, a datanode's death and the SCM's
  ReconstructionCommands over heartbeats (the rebuilt chunks equal the
  lost ones), and `scan_once` on every live daemon. The native PUT, GET,
  degraded GET and repair must move every chunk over the native lane (no
  RPC chunk call, no server-side chunk span; on the PUT and GET no
  fallback and every payload byte counted as moved), and each prints its
  host copies per chunk. Then `python -m ozone_tpu_torch.tools cluster
  --datanodes 10 --device cuda` as processes, driven through the CLI (`sh
  volume/bucket create`, `sh key put/get` of 64 MiB + 12 345 B with a byte
  compare, `freon ockg -n 8 -s 16777216` (16 in the cell), `admin status`:
  10 HEALTHY),
  torn down by pid; every datanode log names its native port, and their
  lane counts show the chunks rode the native lane only. Beside those CLI
  commands, `s3g --require-auth --device cuda` runs as a process in front
  of that cluster: `s3 getsecret`, a signed PUT and GET of the same key's
  bytes, a 3-part multipart upload and `freon s3kg -n 8` (16 in the
  cell), each byte-exact; stopped, it prints its kernel launches and service
  dispatches, which must be equal;
- the S3 gateway (`s3_path`): an `S3Gateway` with require_auth in this
  process, in front of an OzoneClient over an ScmOmDaemon and 12
  DatanodeDaemons (native lane), bucket rs-6-3-1024k, every request
  SigV4-signed with a secret from `s3 getsecret`: concurrent clients
  (four in the cell, one in `main`) each PUT 64 MiB (payload hash signed) and upload 96 MiB +
  12 345 B in 8 MiB parts, four in flight (ListParts and
  ListMultipartUploads checked before the complete); GETs whole, 8 MiB
  ranges across part boundaries and a suffix range; HEAD; ListObjectsV2
  with a delimiter and max-keys paging; an aws-chunked PUT of 16 MiB and a
  presigned GET; unsigned and badly signed PUTs refused (403); the same
  bytes PUT and GET through the OzoneClient alone; and a degraded GET of
  the multipart objects with two holders of their data units stopped.
  Every body is byte-exact, every ETag the body's MD5 or the multipart
  composite, launches equal service dispatches, and the native lane sees
  no fallback and no RPC chunk call;
- lifecycle tiering (`lifecycle_path`): a MiniOzoneCluster of 9
  datanodes with OZONE_TPU_TIER_BATCH=16; a RATIS/THREE bucket of 16 keys
  of 16 MiB (2 in `main`), 8 of 1 MiB + 12 345 B and 4 XOR(6,1) keys of 12 MiB + 7 B,
  tiered to rs-6-3-1024k by one sweep of an age-0 rule (the XOR keys
  through the fused re-encode, the rest in [16, 6, 1 MiB] windows of many
  keys); every key re-read byte-exact and every unit's chunks, parity and
  CRC words equal to the numpy coder's and the host CRC32C; an EXPIRE rule
  on half the short keys; then, over 9 DatanodeDaemons, the rule PUT
  through the S3 gateway's `?lifecycle` and `lifecycle run-now` over the
  remote OM on two keys, read back through the gateway;
- the small-object path (`small_object_path`): over an ScmOmDaemon and 9
  DatanodeDaemons, `sh bucket set-smallobj` on an rs-6-3-1024k bucket,
  `freon tinyg` of 2000 keys of 64 KiB on 16 threads (needles packed into
  slabs), 2000 keys of the tiny mix (inline values and needles), and 500
  keys of 64 KiB with packer=False (the stripe path), all read back
  byte-exact, the first slab's units against the numpy coder and host
  CRC32C; then half the needles deleted, their bytes booked dead, a
  bounded `compact_slabs_once`, the survivors read back byte-exact. Both
  print the metadata RPCs per step (CreateContainer, GetBlock, ...), and
  kernel launches equal the codec service's dispatches in every step.
  `main` runs it at a cut depth (64 keys per tinyg run, 16 on the
  stripe path) to leave room for the later phases;
- consensus and HA (`ha_path`): three ScmOmDaemons on one metadata ring
  (OM and SCM state on one Raft ring over the port's RPC) and 9
  DatanodeDaemons on 3 racks, rs-6-3-1024k on the card: (a) 8 × 64 MiB
  keys through the ring on 4 threads (GiB/s, the leader's raft
  commit_seconds p50/p99, `om:submit` seconds, every chunk against the
  numpy coder's parity and the host CRC32C), (b) 16 × 16 MiB keys while
  the leader is stopped after the 4th acknowledged key (failover seconds,
  retries; every acknowledged key read back byte-exact from the new
  leader), the old leader revived and caught up, `admin ring-status`
  from every replica in sync, (c) 8 × 16 MiB RATIS/THREE keys through the
  datanode pipeline rings with one member stopped after the 2nd key
  (GiB/s, the raft round trips of `write_chunk_commit` and `put_block`),
  (d) a degraded GET of (a)'s keys with two datanodes down through the
  decode form. Launches equal dispatches in (a), (b) and (d). `main` cuts
  (a) to 2 keys, (b) to 8 and (c) to 4;
- the filesystem namespace (`fs_path`): an ScmOmDaemon and 9
  DatanodeDaemons, an FSO bucket at rs-6-3-1024k: (a) TestDFSIO, 8 ×
  64 MiB through `RootedOzoneFileSystem` on 4 threads, read back, each
  file's composite checksum (from the stored chunk CRCs) equal to the
  host CRC32C; (b) `HttpFSGateway`: 2 × 64 MiB by the two-step CREATE,
  OPEN whole and ranged, GETFILECHECKSUM, LISTSTATUS, RENAME, DELETE, a
  degraded OPEN with two datanodes down (the decode form), 16 MiB through
  libo3fs (`csrc/libo3fs/o3fs.c`, gcc) with ctypes; (c) mdtest-easy, 4 ×
  500 empty files created, stat'ed and listed in pages; (d) that tree
  renamed (one row) and deleted recursively with two of (a)'s files, the
  daemon's directory-deleting pass timed until the files' blocks are gone;
  (e) a RATIS/THREE file hsynced after each of 4 × 4 MiB, read by a second
  client, its writer abandoned, `recover_lease`, the stale hsync and an EC
  hsync refused; (f) `freon fsg` and `fskg` of 128 × 3901 B on 8 threads.
  Launches equal dispatches in every part that codes. `main` cuts (a) to
  4 files, (c) to 60 files per directory and (f) to 16 files;
- authorization and tokens (`security_path`): an ScmOmDaemon with block
  tokens (`insecure_secrets`: the keys ride Register and Heartbeat in the
  clear, so the native lane stays on; `encryption_path` runs them over
  mutual TLS) and native ACLs on, 9 DatanodeDaemons on 3 racks (native
  lane), an S3Gateway with require_auth, rs-6-3-1024k: (a) two tenants
  of two users (one each in `main`) each PUT 64 MiB and upload 96 MiB +
  12 345 B in 8 MiB parts, GET whole and ranged, then a degraded GET with
  two datanodes' servers down; the same PUTs and GETs first on a cluster
  with tokens and ACLs off (the secured/unsecured ratio is printed);
  (b) another tenant's bucket answers NoSuchBucket to a PUT and a GET,
  a canned public-read `?acl` lets an anonymous GET through and
  `private` turns it away, the `?acl` body reads back as set, HttpFS
  GETACLSTATUS and CHECKACCESS; (c) on the RPC lane, the sidecar and a
  RATIS/THREE pipeline, no token, a forged signature, an expired token, a
  READ token used to write, another block's token and another
  container's token are each refused with BLOCK_TOKEN_VERIFICATION_FAILED
  and change nothing; (d) a key rotation, a GET under the old key's
  tokens, and the seconds to the first write under the new key; (e) a
  datanode dies and the SCM's reconstruction rebuilds its units onto a
  spare that joined, with tokens the datanodes sign themselves; (f) a
  delegation token used by a second client (a listing and a read under
  the owner's ACL grant), renewed, cancelled and then refused. It prints
  verify microseconds per check on each lane, `check_access` microseconds
  per authorizer check, refusals by reason and repair MiB/s per target;
  launches equal dispatches in every coding step;
- encryption at rest and in transit (`encryption_path`): an ScmOmDaemon
  with `secure=True` (the cluster CA, mutual TLS on every channel with the
  CRL checked per call, block tokens whose keys ride only mTLS) and 9
  DatanodeDaemons on 3 racks enrolled at its enrollment endpoint (no
  native sidecar: chunks ride the TLS RPC), a remote OzoneClient with its
  own certificate, rs-6-3-1024k: (a) 4 × 64 MiB and 96 MiB + 12 345 B PUT
  concurrently into a TDE bucket (master key mk1) and a plain one and read
  back (TDE+mTLS against plain+mTLS GiB/s, the host's ctr_crypt GiB/s);
  every TDE data unit equals ctr_crypt of the source under the DEK the KMS
  unwraps, no cell the plaintext, parity and CRCs the plain coder's over
  the ciphertext; (b) 16 ranged GETs of 1 MiB + 7 B off the AES block, an
  encrypted multipart upload in 8 MiB parts through an S3Gateway with
  require_auth and its own certificate, read whole and across part
  boundaries; (c) a degraded GET of ciphertext (the decode form) with two
  holders stopped, then a datanode's death and the SCM's reconstruction
  onto an enrolled spare (rebuilt chunks equal the lost ciphertext,
  MiB/s per target); (d) mk1 rotated, EDEK versions 0 and 1 read back;
  (e) GDPR: the secret erased in the delete's apply, the raw chunks left
  are ciphertext, an FSO directory's recursive delete erases every
  child's; (f) no certificate (UNAVAILABLE), a bad enrollment secret,
  no token, a revoked certificate (CERTIFICATE_REVOKED, seconds from the
  revoke), a certificate renewed live under PUTs with no failed call, ms
  per TLS handshake, seconds per enrollment. Launches equal dispatches in
  every coding step and no chunk rides a native stream. A line before
  the phases names the host's `cryptography` and `ssl`, and the run fails
  without either. `main` cuts it to 1 big key, 4 ranged GETs and 2
  renewal rounds;
- the rest of the SCM (`scm_admin_path`): an ScmOmDaemon and 12
  DatanodeDaemons on 4 racks with 2 volumes each, rs-6-3-1024k, a client
  reading nearest-first from /rack0, 9 keys of 68 MiB + odd tails: (a) a
  volume removed under them, its units rebuilt by decode from the report
  delta (MiB/s per target), a PUT after it on the healthy volume only;
  (b) `admin datanode decommission` (a process) under 4 writers, nothing
  allocated on the draining node, its units copied off byte-exact (drain
  seconds, bytes), the node stopped and dead, every key GET byte-exact;
  (c) a node decommissioned and stopped at once, declared DEAD, its units
  rebuilt by decode; (d) `admin datanode maintenance` and `recommission`,
  the excess deleted; (e) the SCM restarted mid-drain, the drain relearnt
  from its store and the node's echo; (f) the dead node back, both
  drained nodes recommissioned, `admin balancer start` with a 16 MiB band
  until no move is left (moves, used spread), every key GET byte-exact,
  `balancer_status()` across another SCM restart; (g) `admin datanode
  list`, `pipeline list`, `replicationmanager` and `balancer status` as
  processes. Every rebuilt or copied chunk and its CRCs equal the lost
  one's; launches equal dispatches in every step; the only datanode
  commands that may fail are the two shared faults of ROADMAP Queue 3
  (printed by step and type); the port's log records are held back and
  printed only if the phase fails;
- bucket snapshots (`snapshot_path`, Apache Ozone's feature/Snapshot.md):
  an ScmOmDaemon and 10 DatanodeDaemons, rs-6-3-1024k, an OBS bucket of 6
  keys of 64 MiB and odd tails and an FSO bucket of 4 files of 16 MiB
  under /d/e/: (a) snapshot s1 of each (create ms with the bucket full,
  no row copied), 8 more (create ms beside them); (b) overwrites,
  deletes, a rename and an add, /d renamed to /d2, and 3 alternating
  pairs of 64 MiB PUTs into the snapshotted bucket and one without
  snapshots (GiB/s of each); (c) snapshot s2, every key of s1 and s2 GET
  through `.snapshot/` byte-exact; (d) a data-unit holder stopped, the
  deleted and overwritten keys' `.snapshot/s1/` GETs decode on the card;
  (e) the s1 -> s2 diffs, synchronous and paged, equal to the expected
  set (which route answered); (f) the key-deleting service keeps every
  chunk file while snapshots exist, then every snapshot deleted newest
  first and the seconds to the last chunk file gone; (g) a PUT past a
  bucket quota refused with QUOTA_EXCEEDED, `repair_quota` unchanged,
  HttpFS's snapshot verbs, `sh snapshot` and `sh bucket setquota` as
  processes. Launches equal dispatches in every step;
- geo replication (`geo_path`, rules in AWS S3's PutBucketReplication
  shape): two daemon clusters in this process, the source an
  ScmOmDaemon with 10 DatanodeDaemons (rs-6-3-1024k), the destination
  one with 6, the source's shipper dialing the destination over the RPC:
  (a) 4 keys of 64 MiB and odd tails and 16 of 4 MiB + 7 B under logs/
  in bucket `src`, 2 of 64 MiB + 12 345 B in `src2`, PUT concurrently;
  (b) rule `logs` through the S3 gateway's PUT ?replication (ARN form,
  rs-3-2-1024k), rule `all` through `replication set` (a process); GET
  ?replication re-PUTs unchanged; (c) the bootstrap through GeoRunNow:
  every key byte-exact at RS(3,2), units and CRCs checked, no decode, a
  second cycle ships nothing; (d) last-writer-wins both ways, one
  conflict each; (e) a data-unit holder of src2 stopped, src2's
  bootstrap decodes at the source; (f) the source daemon restarted with
  a 0.5 s cadence resumes at its cursor shipping nothing again, then a
  churn of 4 writers converges to lag 0 (seconds, peak lag); (g) `freon
  geo` as a process, `replication status`, DELETE ?replication, after
  which the cluster commits no geo checkpoint. Launches equal dispatches
  in every step, split by form (the source's decodes, the encodes);
- the sharded metadata plane (`shard_path`, docs/OPERATIONS.md "Sharded
  metadata plane" and bench.py's bench_meta_ops): 4 shards over 64 slots
  sharing the SCM of a MiniOzoneCluster of 10 datanodes: (a) 4 writers
  PUT 8 keys of 64 MiB and odd tails into 8 rs-6-3-1024k buckets, two
  per shard (GiB/s, two keys' units and CRCs against the numpy coder,
  every key byte-exact); (b) three cross-shard renames, two with a
  coordinator crash and `recover` (presumed abort, then commit), no
  launch and no chunk write; (c) a degraded GET of a renamed key decoding
  on the card; (d) `migrate_slot` under 4 writers of 4 MiB keys, no
  acknowledged key lost; (e) a GET through a cross-shard bucket link;
  (f) ring mode (2 shards of 3 replicas, follower reads): ommg's rl mix at
  a hit rate >= 0.8 and a leader killed mid-rename; (g) MiniShardedCluster
  riding out `move_slot`, `admin shards map` through the CLI, and omkg
  ops/s at 1, 2 and 4 in-process shards and 1 and 4 `shardd` processes
  (their start seconds, exit 0 on SIGTERM);
- upgrade finalization and the operator's view (`ops_path`, Apache
  Ozone's feature/Nonrolling-Upgrade.md, feature/Observability.md and
  feature/Reconfigurability.md): an ScmOmDaemon with its HTTP server and
  Recon and 10 DatanodeDaemons, rs-6-3-1024k, the metadata services and
  nine datanodes at layout 2 and one at 0: (a) `admin upgrade`, 4 keys of
  64 MiB and odd tails PUT with every member downgraded to per-chunk
  verbs (counted per member), a snapshot create, an aws-chunked S3 PUT and
  a StreamWriteBlock refused with NOT_SUPPORTED_OPERATION_PRIOR_
  FINALIZATION; (b) `admin finalizeupgrade` (seconds until every datanode
  reports the latest layout), 4 keys on the native batched lane (GiB/s
  against (a)'s), the three verbs succeed; (c) Recon's tasks, du, the
  container-key map, `/api/codec` against the launch counter, the node
  layouts, the warehouse; (d) a degraded GET decoding on the card, Recon's
  unhealthy and healthy views around the SCM's rebuild; (e) `/prom` under
  the golden rules with exemplars, `/stacks`, live reconfiguration; (f)
  insight against a datanode, a PUT's trace at the collector with its
  critical path, and `audit` over the OM's audit log;
- fault injection and the repair tools (`chaos_path`, Apache Ozone's
  hadoop-ozone/fault-injection-test and docs/OPERATIONS.md): (a)
  `run_chaos` on a MiniOzoneCluster of 12 (max 3 down, 0.3 s, 20 s of
  6 MiB + 4 KiB keys; 12 s in `main`), every committed key byte-exact; (c) an
  owner-scoped partition isolating the leader of a three-replica ring;
  on an ScmOmDaemon and 10 DatanodeDaemons: (b) partitions, a 0.5 s
  delay (a hedged GET) and a count-limited WriteChunksCommit rule on
  both lanes, the CLI's `insight partition|heal`, the OM's admission;
  (f) freon's rawcoder, dcg, dcb, dcv, dnbp, ralg, hsg, sdg, scmtb, cmdw,
  dbgen, dnsim and `om_scale` at 100 000 keys (40 000 in `main`); (d) a `datanode` process
  under the LD_PRELOAD injector (EIO, then corrupted writes its scanner
  finds, rebuilt by the SCM, `debug container-inspect` offline); (e)
  `fsck` from DEGRADED to HEALTHY around a rebuild, `debug
  verify-replicas|chunk-info|export-container|import-container`,
  `repair orphans|quota|transaction`, and safemode's pipeline rules
  after a restart;
- the multi-device codec (`mesh_path`, the reference's
  `parallel/{sharded,mesh_executor,multihost}.py`, BASELINE config #5):
  (a) on a logical mesh of 4 slots on cuda:0, RS(6,3) and RS(10,4) at
  1 MiB cells with CRC32C over 16 KiB, the DP encode [32, 6, 1 MiB], the
  DP decode [2, 10], the TP encode of RS(6,3) on 3 slots and of RS(10,4)
  on 2, and the ring decode of RS(10,4) with units 0 and 1 lost (10
  survivors padded to 12), each equal to the single-device kernel and
  the plain version bit for bit, with its launches a call (DP n, TP
  n + 1, ring n + n(n - 1) + n); (b) a `MeshExecutor` on that mesh,
  installed as the process singleton, under four encode and four decode
  operations at once; (c) a degraded RS(10,4) GET over the ring, a
  rebuild through `ECReconstructionCoordinator(mesh=)`, a scrub with
  `mesh=`, a `ReconstructionStorm(executor=)` and the codec service's
  spill at watermark 4, every one byte-exact, on in-process datanodes;
  then the forms' CUDA-event times beside the single-device kernel's,
  the plain version's and the bound; (d) with two or more GPUs the forms
  on a mesh of every GPU and a two-process NCCL run, and with one a line
  saying that neither was run. `--mesh-only` runs the build, the kernel
  cases and this phase alone;
- the host coding backend (`host_path`, the reference's
  `codec/fused.py` twin and policy, OZONE_TPU_FUSED_BACKEND): (a) under
  `auto`, the link probe (pageable h2d and d2h, pinned beside them), the
  host twin's rate for rs-6-3, rs-10-4 and lrc-12-2-2 at 1 MiB cells and
  the verdicts for the encode (3/6) and two decodes (2/10, 1/6), each
  checked against the ceiling formula on the printed numbers; (b) the
  twin against the kernel and its plain version on every CRC32C encode
  and decode case above, and a CRC32 spec under `native` launching the
  kernel once; (c) three alternating native/CUDA pairs through the codec
  service of an RS(6,3) PUT of a 192 MiB key (read back exact) and an
  RS(10,4) degraded GET of 96 MiB + 12 345 B with units 0 and 1 down, each
  run's GiB/s, launches, twin calls and dispatches (CUDA: launches equal
  dispatches; native: no launch, twin calls equal dispatches); (d) a
  `MeshExecutor` on 4 logical slots under `native`: an encode and a decode
  program on the twin, no launch, equal to the kernel; (e) a PUT under
  `auto` whose launches follow (a)'s encode verdict. `--host-only` runs
  the build, the kernel cases and this phase alone.

The kernel cases also hold the coder SPI's two forms of the kernel (no
CRC rows) against their plain versions: the matrix apply
(`torch_coder.gf_apply`: RS(6,3) at cells of 1, 100, 4097 B and 1 MiB,
an RS(10,4) [4, 10] decode) and the XOR reduce (k = 3, 6, 10); the
kernels' JSON has one entry for each form beside the kernel's own.

Every failure raises. A line "phase seconds" gives each phase's command
time. The last line is one JSON object with "ok" and the device; the line
before it is nvidia-smi's name and power limit, and the one before that
the kernels' JSON line. --kernel-only stops after the
build, the kernel cases and the timings (no main paths; the kernels' JSON
then has "launches": null) and prints the same last lines.

It exits non-zero with no result when CUDA is not available.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import logging
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch

MIB = 1 << 20
#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, int8 ops/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, calls: int = 1, rounds: int = 20) -> float:
    """Device time per call: CUDA events around `calls` back-to-back calls
    of fn(), divided by `calls`; the median of `rounds` such runs, after
    one warm-up. With one call a round, host time inside the call that
    leaves the card idle counts; in a run of calls the host enqueues
    ahead, so its time hides unless a call launches slower than it runs."""
    fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def fused_bound(b: int, k: int, p: int, cell: int, bpc: int,
                rows: int | None = None) -> tuple[float, str]:
    """(least ms, what bounds it) for one fused pass over [b, k, cell] that
    writes p output rows and CRCs `rows` rows (k + p for encode, the p
    recovered rows for decode): each input byte read once, outputs and CRC
    words written once; the operations are p GF multiply-adds per input
    byte plus one CRC step per byte of each CRC'd row, counted against the
    int8 peak."""
    rows = k + p if rows is None else rows
    moved = b * k * cell + b * p * cell + b * rows * (cell // bpc) * 4
    ops = b * cell * (2 * k * p + rows)
    t_bytes, t_ops = moved / HBM_BYTES_S * 1e3, ops / INT8_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ kernel phase
def check_kernel_cases(device, cases, seed: int) -> float:
    """Kernel against plain on each (k, p, cell, bpc, B, checksum[, crc_in[,
    scheme]]) case, exact on every byte and word; sampled slices against
    the host CRC. The matrix is the RS generator, or that of `scheme`
    (e.g. "lrc-12-2-2"); p = 0 is a plain slice CRC of the k inputs, the
    scrubber's form. Returns the largest difference seen (0 when every
    case agrees)."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _POLY, _parity_matrix
    from ozone_tpu_torch.utils.checksum import ChecksumType, crc32c

    rng = np.random.default_rng(seed)
    worst = 0
    for k, p, cell, bpc, b, checksum, *rest in cases:
        crc_in = rest[0] if rest else True
        scheme = rest[1] if len(rest) > 1 else f"rs-{k}-{p}"
        data = torch.from_numpy(rng.integers(0, 256, (b, k, cell), dtype=np.uint8)).to(device)
        matrix = (_parity_matrix(CoderOptions.parse(f"{scheme}-{cell}")) if p
                  else np.zeros((0, k), dtype=np.uint8))
        matrix = torch.from_numpy(matrix).to(device)
        poly = _POLY.get(ChecksumType[checksum])
        out, crcs = fused_kernel.fused_encode_crc(data, matrix, poly, bpc, crc_in)
        pout, pcrcs = fused_kernel.fused_encode_crc_plain(data, matrix, poly, bpc, crc_in)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        diff = max((out.int() - pout.int()).abs().max().item() if out.numel() else 0,
                   (crcs.long() - pcrcs.long()).abs().max().item() if crcs.numel() else 0)
        worst = max(worst, diff)
        rows = (k if crc_in else 0) + p if poly else 0
        shape_ok = out.shape == (b, p, cell) and crcs.shape == (b, rows, cell // bpc)
        print(f"kernel vs plain {scheme} cell={cell} bpc={bpc} B={b} {checksum} "
              f"crc_in={crc_in}: max_abs_err={diff} crcs={tuple(crcs.shape)}")
        if diff or not shape_ok:
            raise AssertionError(f"kernel disagrees with plain on {scheme} cell={cell} "
                                 f"bpc={bpc} B={b} {checksum} crc_in={crc_in}")
        if poly is None:
            continue
        units = torch.cat([data, out] if crc_in else [out], 1).cpu().numpy()
        words = crcs.cpu().numpy().view(np.uint32)
        host = crc32c if checksum == "CRC32C" else (lambda a: zlib.crc32(a.tobytes()))
        for _ in range(64 if bpc < cell else 8):
            bi, u, s = (int(rng.integers(n)) for n in (b, rows, cell // bpc))
            want = host(units[bi, u, s * bpc:(s + 1) * bpc])
            if int(words[bi, u, s]) != want:
                raise AssertionError(f"CRC of slice {(bi, u, s)} != host {checksum}")
    return worst


def check_decode_cases(device, cases, seed: int) -> float:
    """The kernel in decode form (an [e, v] recovery matrix, crc_in=False)
    against plain on each (scheme, valid, erased, cell, bpc, B, checksum)
    case: a seeded codeword is encoded by the plain version, the `valid`
    units go in, and the recovered rows must equal the plain version's and
    the erased units, exact; sampled slices against the host CRC. For LRC
    the read set may be narrower than k (a local repair reads group_size
    units). Returns the largest difference seen."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _POLY, _decode_matrix, _parity_matrix
    from ozone_tpu_torch.utils.checksum import ChecksumType, crc32c

    rng = np.random.default_rng(seed)
    worst = 0
    for scheme, valid, erased, cell, bpc, b, checksum in cases:
        opts = CoderOptions.parse(f"{scheme}-{cell}")
        k = opts.data_units
        data = torch.from_numpy(rng.integers(0, 256, (b, k, cell), dtype=np.uint8)).to(device)
        parity, _ = fused_kernel.fused_encode_crc_plain(
            data, torch.from_numpy(_parity_matrix(opts)).to(device), None, bpc)
        units = torch.cat([data, parity], 1)
        inputs = units[:, valid].contiguous()
        matrix = torch.from_numpy(_decode_matrix(opts, valid, erased)).to(device)
        poly = _POLY.get(ChecksumType[checksum])
        rec, crcs = fused_kernel.fused_encode_crc(inputs, matrix, poly, bpc, crc_in=False)
        prec, pcrcs = fused_kernel.fused_encode_crc_plain(inputs, matrix, poly, bpc,
                                                          crc_in=False)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        diff = max((rec.int() - prec.int()).abs().max().item(),
                   (crcs.long() - pcrcs.long()).abs().max().item() if crcs.numel() else 0)
        worst = max(worst, diff)
        rows = len(erased) if poly else 0
        name = (f"{scheme} valid={valid} erased={erased} matrix={tuple(matrix.shape)} "
                f"bpc={bpc} B={b} {checksum}")
        print(f"decode kernel vs plain {name}: max_abs_err={diff} crcs={tuple(crcs.shape)}")
        if diff or crcs.shape != (b, rows, cell // bpc):
            raise AssertionError(f"decode kernel disagrees with plain on {name}")
        if not torch.equal(rec, units[:, erased]):
            raise AssertionError(f"decode of {name} does not give the erased units")
        if poly is None:
            continue
        rec_np, words = rec.cpu().numpy(), crcs.cpu().numpy().view(np.uint32)
        host = crc32c if checksum == "CRC32C" else (lambda a: zlib.crc32(a.tobytes()))
        for _ in range(32):
            bi, u, sl = (int(rng.integers(n)) for n in (b, rows, cell // bpc))
            if int(words[bi, u, sl]) != host(rec_np[bi, u, sl * bpc:(sl + 1) * bpc]):
                raise AssertionError(f"CRC of slice {(bi, u, sl)} of {name} != host")
    return worst


def reencode_inputs(device, k: int, lost: int, cell: int, b: int, seed: int):
    """(units, data, matrix): a seeded XOR(1) group `data` [B, k, cell] on
    `device`, `units` the same with the XOR parity in slot `lost`, and the
    re-encode's [1+p, k] matrix for RS(k, 3)."""
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _reencode_matrix

    rng = np.random.default_rng(seed + lost)
    data = rng.integers(0, 256, (b, k, cell), dtype=np.uint8)
    units = data.copy()
    units[:, lost] = np.bitwise_xor.reduce(data, axis=1)
    matrix = _reencode_matrix(CoderOptions(k, 3, "rs", cell_size=cell), lost)
    return (torch.from_numpy(units).to(device), torch.from_numpy(data).to(device),
            torch.from_numpy(matrix).to(device))


def check_reencode_cases(device, lost_units, cell: int, bpc: int, b: int,
                         seed: int) -> float:
    """The kernel in re-encode form (RS(6,3): the [4, 6] matrix [D[lost];
    P D], CRCs of the 6 inputs and the 4 outputs) against plain for each
    lost unit, exact; the recovered row must equal the lost data unit,
    the rest the RS parity of the group, and sampled slices the host CRC.
    Returns the largest difference seen."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _parity_matrix
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY, crc32c

    k = 6
    rng = np.random.default_rng(seed)
    rs = torch.from_numpy(_parity_matrix(CoderOptions(k, 3, "rs", cell_size=cell))).to(device)
    worst = 0
    for lost in lost_units:
        units, data, matrix = reencode_inputs(device, k, lost, cell, b, seed)
        out, crcs = fused_kernel.fused_encode_crc(units, matrix, CRC32C_POLY, bpc)
        pout, pcrcs = fused_kernel.fused_encode_crc_plain(units, matrix, CRC32C_POLY, bpc)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        diff = max((out.int() - pout.int()).abs().max().item(),
                   (crcs.long() - pcrcs.long()).abs().max().item())
        worst = max(worst, diff)
        name = f"re-encode rs-6-3 lost={lost} matrix={tuple(matrix.shape)} B={b}"
        print(f"re-encode kernel vs plain {name}: max_abs_err={diff} "
              f"crcs={tuple(crcs.shape)}")
        parity, _ = fused_kernel.fused_encode_crc_plain(data, rs, None, bpc)
        if diff or crcs.shape != (b, k + 4, cell // bpc):
            raise AssertionError(f"re-encode kernel disagrees with plain on {name}")
        if not (torch.equal(out[:, 0], data[:, lost]) and torch.equal(out[:, 1:], parity)):
            raise AssertionError(f"{name} does not give the lost unit and the RS parity")
        rows = torch.cat([units, out], 1).cpu().numpy()
        words = crcs.cpu().numpy().view(np.uint32)
        for _ in range(32):
            bi, u, sl = (int(rng.integers(n)) for n in (b, k + 4, cell // bpc))
            if int(words[bi, u, sl]) != crc32c(rows[bi, u, sl * bpc:(sl + 1) * bpc]):
                raise AssertionError(f"CRC of slice {(bi, u, sl)} of {name} != host")
    return worst


def time_reencode(device, cell: int, bpc: int, b: int, seed: int) -> dict:
    """The re-encode form at the XOR->RS path's shape: RS(6,3), B=8, unit 2
    lost, CRC32C over the 6 inputs and 4 outputs."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY

    units, _, matrix = reencode_inputs(device, 6, 2, cell, b, seed)
    return time_form(
        f"re-encode rs-6-3 [4, 6] lost=2 B={b}",
        lambda: fused_kernel.fused_encode_crc(units, matrix, CRC32C_POLY, bpc),
        lambda: fused_kernel.fused_encode_crc_plain(units, matrix, CRC32C_POLY, bpc),
        fused_bound(b, 6, 4, cell, bpc, rows=10), b * 6 * cell)


def time_form(name: str, run, plain, bound: tuple[float, str], in_bytes: int) -> dict:
    """A kernel form's time on fixed inputs, a single call and a call in a
    run of 20, beside its plain version's time and its bound."""
    ms = cuda_ms(run)
    in_run_ms = cuda_ms(run, calls=20, rounds=5)
    plain_ms = cuda_ms(plain, rounds=5)
    bound_ms, bound_by = bound
    print(f"fused_encode_crc {name}: {ms:.4f} ms a single call ({in_run_ms:.4f} ms a call "
          f"in a run of 20), bound {bound_ms:.4f} ms ({bound_by}), "
          f"{in_bytes / ms * 1e3 / 2**30:.2f} GiB/s in, plain {plain_ms:.4f} ms")
    return {"ms": ms, "ms_in_run": in_run_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


def time_decode(device, cell: int, bpc: int, b: int, seed: int) -> dict:
    """The kernel in decode form at the degraded read's shape: RS(10,4),
    units 0 and 1 rebuilt from units 2..11, CRC32C over the two rows."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _decode_matrix
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY

    valid, erased = list(range(2, 12)), [0, 1]
    rng = np.random.default_rng(seed)
    units = torch.from_numpy(rng.integers(0, 256, (b, len(valid), cell), dtype=np.uint8)).to(device)
    matrix = torch.from_numpy(_decode_matrix(CoderOptions(10, 4, cell_size=cell),
                                             valid, erased)).to(device)
    return time_form(
        f"decode rs-10-4 e=2 v=10 cell={cell} bpc={bpc} B={b}",
        lambda: fused_kernel.fused_encode_crc(units, matrix, CRC32C_POLY, bpc, crc_in=False),
        lambda: fused_kernel.fused_encode_crc_plain(units, matrix, CRC32C_POLY, bpc,
                                                    crc_in=False),
        fused_bound(b, len(valid), len(erased), cell, bpc, rows=len(erased)),
        b * len(valid) * cell)


def time_kernel(device, k: int, p: int, cell: int, bpc: int, b: int,
                seed: int, plain: bool) -> dict:
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _parity_matrix
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY

    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(0, 256, (b, k, cell), dtype=np.uint8)).to(device)
    matrix = torch.from_numpy(_parity_matrix(CoderOptions(k, p, cell_size=cell))).to(device)

    def run():
        return fused_kernel.fused_encode_crc(data, matrix, CRC32C_POLY, bpc)

    before = fused_kernel.launches.count
    ms = cuda_ms(run)
    in_run_ms = cuda_ms(run, calls=20, rounds=5)
    launched = fused_kernel.launches.count - before
    plain_ms = (cuda_ms(lambda: fused_kernel.fused_encode_crc_plain(
        data, matrix, CRC32C_POLY, bpc), rounds=5) if plain else None)
    bound_ms, bound_by = fused_bound(b, k, p, cell, bpc)
    print(f"fused_encode_crc rs-{k}-{p} cell={cell} bpc={bpc} B={b}: "
          f"{ms:.4f} ms a single call ({in_run_ms:.4f} ms a call in a run of 20), "
          f"bound {bound_ms:.4f} ms ({bound_by}), "
          f"{b * k * cell / MIB / ms * 1e3 / 1024:.2f} GiB/s in, launches {launched}"
          + (f", plain {plain_ms:.4f} ms" if plain else ""))
    return {"ms": ms, "ms_in_run": in_run_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_parts(device, k: int, p: int, cell: int, bpc: int, b: int, seed: int) -> None:
    """The kernel's two halves apart, at one shape: the GF apply with no
    CRC, and the CRC alone over as many rows (p = 0, k + p input rows)."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _parity_matrix
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY

    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(0, 256, (b, k + p, cell), dtype=np.uint8)).to(device)
    matrix = torch.from_numpy(_parity_matrix(CoderOptions(k, p, cell_size=cell))).to(device)
    inputs = data[:, :k].contiguous()
    no_rows = torch.zeros((0, k + p), dtype=torch.uint8, device=device)
    gf_ms = cuda_ms(lambda: fused_kernel.fused_encode_crc(inputs, matrix, None, bpc),
                    calls=20, rounds=5)
    crc_ms = cuda_ms(lambda: fused_kernel.fused_encode_crc(data, no_rows, CRC32C_POLY, bpc),
                     calls=20, rounds=5)
    print(f"fused_encode_crc rs-{k}-{p} B={b} apart: GF apply alone {gf_ms:.4f} ms, "
          f"CRC alone over {k + p} rows {crc_ms:.4f} ms")


def time_lrc_and_scrub(device, cell: int, bpc: int, seed: int) -> dict:
    """The LRC(12,2,2) encode (B=8, [4, 12] generator, CRC32C over all 16
    rows), its local decode (unit 2 from its group, B=8, [1, 6] matrix,
    CRC32C over the recovered row) and the scrubber's batch (4096 slices
    of bpc bytes through `make_crc_fn`, no coding rows)."""
    from ozone_tpu_torch.codec import fused_kernel, lrc_math
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.crc_device import make_crc_fn
    from ozone_tpu_torch.codec.fused import _decode_matrix, _parity_matrix
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY

    rng = np.random.default_rng(seed)
    lrc = CoderOptions.parse(f"lrc-12-2-2-{cell}")
    b = 8
    data = torch.from_numpy(rng.integers(0, 256, (b, 12, cell), dtype=np.uint8)).to(device)
    gen = torch.from_numpy(_parity_matrix(lrc)).to(device)
    out = {"lrc_encode": time_form(
        f"lrc-12-2-2 encode [4, 12] B={b}",
        lambda: fused_kernel.fused_encode_crc(data, gen, CRC32C_POLY, bpc),
        lambda: fused_kernel.fused_encode_crc_plain(data, gen, CRC32C_POLY, bpc),
        fused_bound(b, 12, 4, cell, bpc), b * 12 * cell)}
    valid, _ = lrc_math.plan_valid(lrc, [2], [u for u in range(16) if u != 2])
    units = data[:, :len(valid)].contiguous()
    rows = torch.from_numpy(_decode_matrix(lrc, valid, [2])).to(device)
    out["lrc_decode"] = time_form(
        f"lrc-12-2-2 local decode [1, {len(valid)}] B={b}",
        lambda: fused_kernel.fused_encode_crc(units, rows, CRC32C_POLY, bpc, crc_in=False),
        lambda: fused_kernel.fused_encode_crc_plain(units, rows, CRC32C_POLY, bpc,
                                                    crc_in=False),
        fused_bound(b, len(valid), 1, cell, bpc, rows=1), b * len(valid) * cell)
    n = 4096
    slices = torch.from_numpy(rng.integers(0, 256, (n, 1, bpc), dtype=np.uint8)).to(device)
    no_rows = torch.zeros((0, 1), dtype=torch.uint8, device=device)
    crc_fn = make_crc_fn(bpc)
    out["scrub"] = time_form(
        f"scrub batch [{n}, 1, {bpc}] (no coding rows)",
        lambda: crc_fn(slices),
        lambda: fused_kernel.fused_encode_crc_plain(slices, no_rows, CRC32C_POLY, bpc),
        fused_bound(n, 1, 0, bpc, bpc, rows=1), n * bpc)
    return out


# --------------------------------------------------------------- main path
def service_counts() -> dict:
    """The shared codec service's dispatch counters, the kernel's launches
    since start read with them under its lock (the service holds it from a
    launch to that dispatch's count, so a dispatch of other work in
    flight at the read is in both or neither), and the observation
    counts and sums of its queue-wait and dispatch histograms
    (process-wide)."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec import service as codec_service

    with fused_kernel.launches.held():
        out = {name: codec_service.METRICS.counter(name).value
               for name in ("submissions", "dispatches", "multi_op_dispatches",
                            "stripes_dispatched", "slots_dispatched",
                            "dispatches_encode", "dispatches_decode",
                            "dispatches_reencode")}
        out["launches_total"] = fused_kernel.launches.total
    for name in ("queue_wait_seconds", "dispatch_seconds"):
        h = codec_service.METRICS.histogram(name)
        out[name], out[f"{name}_n"] = h.total, h.count
    return out


def service_delta(before: dict) -> dict:
    """The service's counters since `before`, with the fill ratio of the
    dispatches in between (stripes over batch slots) and the mean queue
    wait and dispatch time (launch to results on the host) in ms."""
    now = service_counts()
    out = {k: now[k] - before[k] for k in now}
    out["fill_ratio"] = (out["stripes_dispatched"] / out["slots_dispatched"]
                         if out["slots_dispatched"] else 0.0)
    for name, key in (("queue_wait_seconds", "queue_wait_ms"),
                      ("dispatch_seconds", "dispatch_ms")):
        n = out[f"{name}_n"]
        out[key] = 1e3 * out[name] / n if n else 0.0
    return out


@contextlib.contextmanager
def codec_route(service: bool):
    """The enclosed phase takes the shared codec service (the default) or,
    with OZONE_TPU_CODEC_SERVICE=0, the direct route."""
    old = os.environ.get("OZONE_TPU_CODEC_SERVICE")
    os.environ["OZONE_TPU_CODEC_SERVICE"] = "1" if service else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("OZONE_TPU_CODEC_SERVICE")
        else:
            os.environ["OZONE_TPU_CODEC_SERVICE"] = old


class Cluster:
    """In-process port datanodes and a naive group allocator that takes the
    first k+p of them. The client factory raises for a node in `dead`, as
    for a node that is down."""

    def __init__(self, root: Path, opts, n_dn: int):
        from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
        from ozone_tpu_torch.storage.datanode import Datanode

        class Factory(DatanodeClientFactory):
            def get(self, dn_id):
                if dn_id in cluster.dead:
                    raise KeyError(f"datanode {dn_id} is down")
                return super().get(dn_id)

        cluster = self
        self.opts = opts
        self.dead: set[str] = set()
        self.dns = {f"dn{i}": Datanode(root / f"dn{i}", dn_id=f"dn{i}")
                    for i in range(n_dn)}
        self.clients = Factory()
        for dn in self.dns.values():
            self.clients.register_local(dn)
        self._lock = threading.Lock()
        self._next = 0

    def allocate(self, excluded):
        from ozone_tpu_torch.client.ec_writer import BlockGroup
        from ozone_tpu_torch.scm.pipeline import Pipeline, ReplicationConfig

        nodes = [d for d in self.dns if d not in excluded][:self.opts.all_units]
        if len(nodes) < self.opts.all_units:
            raise RuntimeError("not enough datanodes")
        with self._lock:
            self._next += 1
            n = self._next
        return BlockGroup(container_id=n, local_id=n, pipeline=Pipeline(
            ReplicationConfig.from_ec(self.opts), nodes))

    def close(self):
        for dn in self.dns.values():
            dn.close()


def put_keys(cluster: Cluster, keys: list[np.ndarray], device, bpc: int,
             barrier: threading.Barrier | None = None):
    """PUT every key on its own thread; returns (groups per key, writers).
    With a barrier, every writer's close() starts together."""
    from ozone_tpu_torch.client.ec_writer import ECKeyWriter

    results: list = [None] * len(keys)
    errors: list = []

    def put(i):
        try:
            w = ECKeyWriter(cluster.opts, cluster.allocate, cluster.clients,
                            bytes_per_checksum=bpc, device=device)
            data = keys[i]
            for pos in range(0, data.size, 4 * MIB):  # a client's write calls
                w.write(data[pos:pos + 4 * MIB])
            if barrier is not None:
                barrier.wait(timeout=300)
            results[i] = (w.close(), w)
        except BaseException as e:  # reported and re-raised by the caller
            errors.append(e)
            if barrier is not None:
                barrier.abort()

    threads = [threading.Thread(target=put, args=(i,)) for i in range(len(keys))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        if t.is_alive():
            raise TimeoutError("a PUT did not finish")
    if errors:
        raise errors[0]
    return [r[0] for r in results], [r[1] for r in results]


def verify_keys(cluster: Cluster, keys, groups_per_key, device, bpc: int,
                seed: int, samples: int) -> dict:
    """Read every chunk back: data chunks equal the source bytes, parity
    chunks and full-cell CRCs equal the plain version's on `device`, and a
    sample of chunks (the partial ones included) pass read_chunk(verify)."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.fused import _POLY, _parity_matrix
    from ozone_tpu_torch.storage.ids import StorageError
    from ozone_tpu_torch.utils.checksum import ChecksumType

    opts = cluster.opts
    k, p, cell = opts.data_units, opts.parity_units, opts.cell_size
    matrix = torch.from_numpy(_parity_matrix(opts)).to(device)
    poly = _POLY[ChecksumType.CRC32C]
    rng = np.random.default_rng(seed)
    chunks = verified = partial = 0
    refs = []
    for data, groups in zip(keys, groups_per_key):
        if sum(g.length for g in groups) != data.size:
            raise AssertionError("committed lengths do not add up to the key")
        base = 0
        for g in groups:
            n_stripes = -(-g.length // (k * cell))
            stripes = np.zeros((n_stripes, k, cell), dtype=np.uint8)
            stripes.reshape(-1)[:g.length] = data[base:base + g.length]
            base += g.length
            for s0 in range(0, n_stripes, 8):
                batch = torch.from_numpy(stripes[s0:s0 + 8]).to(device)
                par, crcs = fused_kernel.fused_encode_crc_plain(batch, matrix, poly, bpc)
                par, crcs = par.cpu().numpy(), crcs.cpu().numpy().view(np.uint32)
                for u, dn_id in enumerate(g.pipeline.nodes):
                    dn = cluster.dns[dn_id]
                    try:
                        block = dn.get_block(g.block_id)
                    except StorageError:  # a unit the key's data never reached
                        block = None
                    infos = {c.offset // cell: c for c in (block.chunks if block else [])}
                    for j in range(par.shape[0]):
                        s = s0 + j
                        info = infos.get(s)
                        want = stripes[s, u] if u < k else par[j, u - k]
                        if info is None:
                            if u < k and s * k * cell + u * cell < g.length:
                                raise AssertionError(f"missing chunk {g.block_id} {u}/{s}")
                            continue
                        refs.append((dn, g.block_id, info))
                        got = dn.read_chunk(g.block_id, info)
                        chunks += 1
                        if not np.array_equal(got, want[:info.length]):
                            raise AssertionError(f"chunk {info.name} unit {u} differs")
                        if info.length == cell:
                            stored = [int.from_bytes(c, "big") for c in info.checksum.checksums]
                            if stored != crcs[j, u].tolist():
                                raise AssertionError(f"stored CRCs of {info.name} unit {u} "
                                                     "differ from the plain version")
                        else:
                            partial += 1
                            dn.read_chunk(g.block_id, info, verify=True)
                            verified += 1
    for i in rng.choice(len(refs), min(samples, len(refs)), replace=False):
        dn, bid, info = refs[int(i)]
        dn.read_chunk(bid, info, verify=True)
        verified += 1
    return {"chunks": chunks, "verified": verified, "partial": partial}


def put_run(device, opts, keys, bpc: int, seed: int, route: str, what: str,
            barrier: bool = False) -> dict:
    """PUT `keys` concurrently into a fresh cluster of k+p datanodes on
    `route` ("service" or "direct") and check every chunk against the
    source and the plain version. On the service, launches equal the
    service's dispatches; on the direct route, the writers' submissions."""
    from ozone_tpu_torch.codec import fused_kernel

    total = sum(int(k.size) for k in keys)
    with codec_route(route == "service"), \
            tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        cluster = Cluster(Path(tmp), opts, opts.all_units)
        try:
            before = service_counts()
            fused_kernel.launches.reset()
            since, t0 = time.time(), time.perf_counter()
            groups, writers = put_keys(
                cluster, keys, device, bpc,
                barrier=threading.Barrier(len(keys)) if barrier else None)
            wall = time.perf_counter() - t0
            launches = fused_kernel.launches.count
            svc = service_delta(before)
            spans = span_totals(since)
            submissions = sum(w.dispatches for w in writers)
            checked = verify_keys(cluster, keys, groups, device, bpc, seed, 64)
        finally:
            cluster.close()
    print(f"{what} ({route}): {len(keys)} concurrent {opts} PUTs, {total} B in "
          f"{wall:.3f} s = {total / wall / 2**30:.3f} GiB/s, {len(keys) / wall:.1f} PUTs/s "
          f"(wall); kernel launches {launches}, writer submissions {submissions}; service "
          f"dispatches {svc['dispatches']}, multi_op_dispatches "
          f"{svc['multi_op_dispatches']}, fill_ratio {svc['fill_ratio']:.3f}, queue wait "
          f"{svc['queue_wait_ms']:.3f} ms, dispatch {svc['dispatch_ms']:.3f} ms (means); "
          f"{checked['chunks']} chunks byte-exact")
    print(f"{what} ({route}) spans: {spans}")
    dispatches = svc["dispatches"] if route == "service" else submissions
    if svc["submissions"] != (submissions if route == "service" else 0):
        raise AssertionError(f"{what} ({route}): {svc['submissions']} service submissions "
                             f"for {submissions} writer submissions")
    if device.type == "cuda" and (launches <= 0 or launches != dispatches):
        raise AssertionError(f"{what} ({route}): {launches} kernel launches for "
                             f"{dispatches} dispatches")
    if checked["verified"] < 64:
        raise AssertionError("too few chunks verified")
    return {"launches": launches, "dispatches": dispatches, "submissions": submissions,
            "multi_op": svc["multi_op_dispatches"], "fill_ratio": svc["fill_ratio"],
            "gib_s": total / wall / 2**30, "puts_s": len(keys) / wall,
            "partial": checked["partial"]}


#: route order of a paired comparison in one call, after one unmeasured
#: run on each route (the first runs pay for new pinned and device
#: memory): one run on the direct route, one on the service (two of each
#: until the daemon phase needed the run time)
WARMUP, ROUTES = ("service", "direct"), ("direct", "service")
#: host CRC32C routes of the healthy RS(10,4) GET, one run each
CRC_ROUTES = ("native", "numpy")


def compare_routes(device, opts, keys, bpc: int, seed: int, what: str,
                   barrier: bool = False) -> dict:
    """The warm-up runs, then the paired runs; {route: [run, ...]} of the
    paired runs, and "warmup": [run, ...]."""
    warm = [put_run(device, opts, keys, bpc, seed, route, f"{what} warm-up", barrier)
            for route in WARMUP]
    runs = [put_run(device, opts, keys, bpc, seed, route, what, barrier)
            for route in ROUTES]
    out = {route: [r for r, name in zip(runs, ROUTES) if name == route]
           for route in ("service", "direct")}
    out["warmup"] = warm
    return out


def main_path(device, key_sizes, cell: int, bpc: int, seed: int) -> dict:
    """Concurrent RS(6,3) PUTs of the same keys into a fresh cluster, on the
    direct route and on the shared codec service, alternated."""
    from ozone_tpu_torch.codec.api import CoderOptions

    opts = CoderOptions(6, 3, "rs", cell_size=cell)
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 256, n, dtype=np.uint8) for n in key_sizes]
    out = compare_routes(device, opts, keys, bpc, seed, "main path")
    if not all(r["partial"] for runs in out.values() for r in runs):
        raise AssertionError("no partial chunk was verified")
    return out


def small_puts(device, n_keys: int, key_size: int, cell: int, bpc: int,
               seed: int) -> dict:
    """Many small concurrent RS(6,3) PUTs: each key is one full stripe and a
    short tail, both flushed at close() as one partial batch, and every
    close() starts behind one barrier, so on the service the tails reach
    it within its linger and share launches. The direct route, alternated
    with it, launches once per PUT."""
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.pipeline import host_buffer

    opts = CoderOptions(6, 3, "rs", cell_size=cell)
    rng = np.random.default_rng(seed + 2)
    keys = [rng.integers(0, 256, key_size, dtype=np.uint8) for _ in range(n_keys)]
    # the pinned pool of a long-running client already holds blocks of the
    # staging size; without them the first allocations spread the closes
    warm = [host_buffer((2, opts.data_units, cell), device) for _ in range(n_keys)]
    del warm
    out = compare_routes(device, opts, keys, bpc, seed, "small PUTs", barrier=True)
    for r in out["service"]:
        if r["multi_op"] <= 0 or not r["dispatches"] < r["submissions"]:
            raise AssertionError(f"small PUTs: {r['dispatches']} service dispatches for "
                                 f"{r['submissions']} submissions, {r['multi_op']} "
                                 "carrying more than one PUT")
    return out


def read_groups(cluster: Cluster, keys, groups_per_key, device, bpc: int,
                verify: bool = True) -> dict:
    """read_all every block group of every key through a fresh reader (the
    datanodes check each chunk's stored CRCs unless `verify` is off); each
    must equal its source bytes. Returns user bytes, wall seconds of the
    reads, and decode dispatches."""
    from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader

    total = dispatches = 0
    wall = 0.0
    for data, groups in zip(keys, groups_per_key):
        base = 0
        for g in groups:
            reader = ECBlockGroupReader(g, cluster.opts, cluster.clients, verify=verify,
                                        bytes_per_checksum=bpc, device=device)
            t0 = time.perf_counter()
            got = reader.read_all()
            wall += time.perf_counter() - t0
            if not np.array_equal(got, data[base:base + g.length]):
                raise AssertionError(f"read of group {g.block_id} differs from the source")
            base += g.length
            total += g.length
            dispatches += reader.dispatches
    return {"bytes": total, "wall_s": wall, "dispatches": dispatches}


def ranged_reads(cluster: Cluster, keys, groups_per_key, device, bpc: int) -> dict:
    """Ranged reads across cell and stripe boundaries of every group, the
    partial tail included; each must equal its source bytes."""
    from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader

    cell, row = cluster.opts.cell_size, cluster.opts.data_units * cluster.opts.cell_size
    n = dispatches = 0
    for data, groups in zip(keys, groups_per_key):
        base = 0
        for g in groups:
            reader = ECBlockGroupReader(g, cluster.opts, cluster.clients,
                                        bytes_per_checksum=bpc, device=device)
            for off, length in ((cell - 100, 200), (row - 50, 100),
                                (row + cell // 2, 3 * cell),
                                (g.length - cell - 77, cell + 77)):
                if off < 0 or off + length > g.length:
                    continue
                got = reader.read(off, length)
                if not np.array_equal(got, data[base + off:base + off + length]):
                    raise AssertionError(f"ranged read {off}+{length} of {g.block_id} differs")
                n += 1
            base += g.length
            dispatches += reader.dispatches
    return {"ranges": n, "dispatches": dispatches}


def span_totals(since: float) -> str:
    """The port tracer's spans that started at or after `since` (time.time()),
    by name: count and seconds summed over all threads."""
    from ozone_tpu_torch.utils.tracing import Tracer

    totals: dict[str, list] = {}
    for s in Tracer.instance().traces():
        if s.start >= since:
            t = totals.setdefault(s.name, [0, 0.0])
            t[0] += 1
            t[1] += s.duration
    return ", ".join(f"{name} {n} x {secs:.3f} s" for name, (n, secs) in sorted(totals.items()))


def check_launches(what: str, device, launches: int, svc: dict, submissions: int) -> None:
    """The service saw every decode submission of the path and dispatched
    them in at most as many launches; on the card every service dispatch
    is one kernel launch, and the path launched at least once."""
    print(f"{what}: decode launches {launches}, decode submissions {submissions}, "
          f"service dispatches {svc['dispatches']} (multi_op_dispatches "
          f"{svc['multi_op_dispatches']})")
    if svc["submissions"] != submissions or svc["dispatches"] > submissions:
        raise AssertionError(f"{what}: {svc['submissions']} service submissions, "
                             f"{svc['dispatches']} dispatches for {submissions} submissions")
    if device.type == "cuda" and (launches <= 0 or launches != svc["dispatches"]):
        raise AssertionError(f"{what}: {launches} kernel launches for "
                             f"{svc['dispatches']} service dispatches")


def check_rebuilt(cluster: Cluster, groups, lost, spares, bpc: int) -> dict:
    """Every rebuilt replica is CLOSED with the lost replica index, and each
    of its chunks equals the lost unit's stored chunk, with stored CRCs
    equal to the host CRC32C of its bytes."""
    from concurrent.futures import ThreadPoolExecutor

    from ozone_tpu_torch.storage.ids import ContainerState, StorageError
    from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

    host = Checksum(ChecksumType.CRC32C, bpc)
    pairs = []
    per_target = dict.fromkeys(spares, 0)
    for g in groups:
        for u, spare in zip(lost, spares):
            src, dst = cluster.dns[g.pipeline.nodes[u]], cluster.dns[spare]
            c = dst.containers.get(g.container_id)
            if c.state is not ContainerState.CLOSED or c.replica_index != u + 1:
                raise AssertionError(f"rebuilt container {g.container_id} on {spare} is "
                                     f"{c.state.value}, replica index {c.replica_index}")
            try:
                schunks = src.get_block(g.block_id).chunks
            except StorageError:  # a unit holding no bytes of a short group
                schunks = []
            dblk = dst.get_block(g.block_id)
            if [(i.offset, i.length) for i in schunks] != \
                    [(i.offset, i.length) for i in dblk.chunks]:
                raise AssertionError(f"rebuilt chunk list of {g.block_id} unit {u} differs")
            per_target[spare] += dblk.length
            pairs += [(src, dst, g.block_id, si, di)
                      for si, di in zip(schunks, dblk.chunks)]

    def check(pair):
        src, dst, bid, si, di = pair
        got = dst.read_chunk(bid, di)
        if not np.array_equal(got, src.read_chunk(bid, si)):
            raise AssertionError(f"rebuilt chunk {di.name} differs from the lost one")
        if host.compute(got).checksums != di.checksum.checksums:
            raise AssertionError(f"stored CRCs of rebuilt chunk {di.name} != host CRC32C")
        return di.length < cluster.opts.cell_size

    with ThreadPoolExecutor(8) as pool:
        partial = sum(pool.map(check, pairs))
    return {"chunks": len(pairs), "partial": partial, "per_target": per_target}


def read_repair_path(device, key_sizes, cell: int, bpc: int, seed: int) -> dict:
    """RS(10,4) read and repair: PUT the keys into 16 datanodes (groups on
    the first 14), read every group healthy, then with the datanodes of
    units 0 and 1 down (whole and ranged), rebuild replica indexes 1 and 2
    of every container onto the two spares, and read again through the
    rebuilt replicas with units 2 and 3 down, all on the shared codec
    service. Kernel launches are counted from 0 for each run and must equal
    the service's dispatches in it."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.storage.reconstruction import (
        ECReconstructionCoordinator,
        ReconstructionCommand,
    )
    from ozone_tpu_torch.utils import checksum

    opts = CoderOptions(10, 4, "rs", cell_size=cell)
    rng = np.random.default_rng(seed + 1)
    keys = [rng.integers(0, 256, n, dtype=np.uint8) for n in key_sizes]
    lost, spares = [0, 1], ["dn14", "dn15"]
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-rr-") as tmp:
        cluster = Cluster(Path(tmp), opts, 16)
        try:
            before = service_counts()
            fused_kernel.launches.reset()
            groups_per_key, writers = put_keys(cluster, keys, device, bpc)
            out["put_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            groups = [g for gs in groups_per_key for g in gs]
            total = sum(key_sizes)
            print(f"read/repair: rs-10-4 PUT of {len(keys)} keys, {total} B, "
                  f"{len(groups)} block groups on 14 of 16 datanodes; encode launches "
                  f"{out['put_launches']} for {svc['dispatches']} service dispatches of "
                  f"{sum(w.dispatches for w in writers)} writer submissions")
            if device.type == "cuda" and out["put_launches"] != svc["dispatches"]:
                raise AssertionError("rs-10-4 PUT: launches differ from service dispatches")

            # the healthy GET with the datanodes' CRC check on each host
            # CRC32C route: native, then numpy
            crc_rates: dict[str, list[float]] = {"native": [], "numpy": []}
            for route in CRC_ROUTES:
                fused_kernel.launches.reset()
                since = time.time()
                with (checksum.numpy_route() if route == "numpy"
                      else contextlib.nullcontext()):
                    if checksum.route() != route:
                        raise AssertionError(f"host CRC32C runs on {checksum.route()}, "
                                             f"not {route}")
                    healthy = read_groups(cluster, keys, groups_per_key, device, bpc)
                launches = fused_kernel.launches.count
                rate = healthy["bytes"] / healthy["wall_s"] / 2**30
                crc_rates[route].append(rate)
                print(f"healthy GET spans ({route} CRC32C): {span_totals(since)}")
                print(f"healthy GET ({route} host CRC32C): {rate:.3f} GiB/s (wall), "
                      f"{healthy['bytes']} B byte-exact in {healthy['wall_s']:.3f} s; "
                      f"decode launches {launches}, dispatches {healthy['dispatches']}")
                if launches or healthy["dispatches"]:
                    raise AssertionError("a healthy read decoded")
            print("healthy GET by host CRC32C route: " + ", ".join(
                f"{route} {' '.join(f'{r:.3f}' for r in rates)} GiB/s"
                for route, rates in crc_rates.items()))
            unverified = read_groups(cluster, keys, groups_per_key, device, bpc, verify=False)
            print(f"healthy GET without the datanodes' CRC check: "
                  f"{unverified['bytes'] / unverified['wall_s'] / 2**30:.3f} GiB/s (wall)")

            cluster.dead = {groups[0].pipeline.nodes[u] for u in lost}
            before = service_counts()
            fused_kernel.launches.reset()
            since = time.time()
            degraded = read_groups(cluster, keys, groups_per_key, device, bpc)
            out["degraded_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            print(f"degraded GET spans: {span_totals(since)}")
            print(f"degraded GET (units {lost} down): "
                  f"{degraded['bytes'] / degraded['wall_s'] / 2**30:.3f} GiB/s (wall), "
                  f"{degraded['bytes']} B byte-exact in {degraded['wall_s']:.3f} s")
            check_launches("degraded GET", device, out["degraded_launches"], svc,
                           degraded["dispatches"])

            before = service_counts()
            fused_kernel.launches.reset()
            ranged = ranged_reads(cluster, keys, groups_per_key, device, bpc)
            out["ranged_launches"] = fused_kernel.launches.count
            print(f"ranged degraded reads: {ranged['ranges']} ranges byte-exact")
            check_launches("ranged degraded reads", device, out["ranged_launches"],
                           service_delta(before), ranged["dispatches"])

            coord = ECReconstructionCoordinator(cluster.clients, bytes_per_checksum=bpc,
                                                device=device)
            cmds = [ReconstructionCommand(
                g.container_id, opts,
                {u + 1: n for u, n in enumerate(g.pipeline.nodes) if u not in lost},
                {u + 1: spare for u, spare in zip(lost, spares)}) for g in groups]
            before = service_counts()
            fused_kernel.launches.reset()
            since, t0 = time.time(), time.perf_counter()
            for cmd in cmds:
                coord.reconstruct_container_group(cmd)
            repair_s = time.perf_counter() - t0
            out["repair_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            print(f"repair spans: {span_totals(since)}")
            rebuilt = check_rebuilt(cluster, groups, lost, spares, bpc)
            per_target = statistics.mean(rebuilt["per_target"].values())
            print(f"repair: {len(cmds)} containers, replica indexes "
                  f"{[u + 1 for u in lost]} onto {spares} in {repair_s:.3f} s: "
                  f"{per_target / repair_s / MIB:.1f} MiB/s per target datanode (wall), "
                  f"{per_target:.0f} B per target; {rebuilt['chunks']} rebuilt chunks "
                  f"({rebuilt['partial']} partial) equal the lost ones, CRCs equal host CRC32C")
            check_launches("repair", device, out["repair_launches"], svc,
                           coord.metrics.counter("decode_dispatches").value)

            for g in groups:
                for u, spare in zip(lost, spares):
                    g.pipeline.nodes[u] = spare
            cluster.dead = {groups[0].pipeline.nodes[u] for u in (2, 3)}
            before = service_counts()
            fused_kernel.launches.reset()
            reread = read_groups(cluster, keys, groups_per_key, device, bpc)
            out["reread_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            print(f"re-read through the rebuilt replicas (units [2, 3] down): "
                  f"{reread['bytes'] / reread['wall_s'] / 2**30:.3f} GiB/s (wall), "
                  f"byte-exact")
            check_launches("re-read", device, out["reread_launches"], svc,
                           reread["dispatches"])
        finally:
            cluster.close()
    out["decode_launches"] = sum(out[k] for k in ("degraded_launches", "ranged_launches",
                                                  "repair_launches", "reread_launches"))
    out.update(healthy_gib_s=crc_rates,
               degraded_gib_s=degraded["bytes"] / degraded["wall_s"] / 2**30,
               repair_mib_s_per_target=per_target / repair_s / MIB)
    return out


@contextlib.contextmanager
def spy_reads(cluster: Cluster):
    """Count the bytes each datanode serves through its client while the
    block runs (`read_chunks` goes through the spied `read_chunk`)."""
    served: dict[str, int] = {}
    lock = threading.Lock()
    clients = list(cluster.clients._local.items())

    def spied(dn_id, fn):
        def read_chunk(*a, **kw):
            data = fn(*a, **kw)
            with lock:
                served[dn_id] = served.get(dn_id, 0) + int(data.size)
            return data
        return read_chunk

    for dn_id, c in clients:
        c.read_chunk = spied(dn_id, c.read_chunk)
    try:
        yield served
    finally:
        for _, c in clients:
            del c.read_chunk


def degraded_lrc_get(cluster: Cluster, keys, groups_per_key, device, bpc: int,
                     down: list[int], what: str) -> dict:
    """read_all of every group with the datanodes of units `down` out, on
    the service; byte-exact, and launches equal the service's dispatches."""
    from ozone_tpu_torch.codec import fused_kernel

    cluster.dead = {groups_per_key[0][0].pipeline.nodes[u] for u in down}
    before = service_counts()
    fused_kernel.launches.reset()
    got = read_groups(cluster, keys, groups_per_key, device, bpc)
    launches = fused_kernel.launches.count
    print(f"lrc {what} GET (units {down} down): "
          f"{got['bytes'] / got['wall_s'] / 2**30:.3f} GiB/s (wall), {got['bytes']} B "
          f"byte-exact in {got['wall_s']:.3f} s")
    check_launches(f"lrc {what} GET", device, launches, service_delta(before),
                   got["dispatches"])
    cluster.dead = set()
    return {"launches": launches, "gib_s": got["bytes"] / got["wall_s"] / 2**30}


def lrc_path(device, key_sizes, cell: int, bpc: int, seed: int) -> dict:
    """LRC(12,2,2) on 18 datanodes (16 units, 2 spares), all on the shared
    codec service: concurrent PUTs, a healthy GET (no decode), degraded
    GETs with unit 2 down (local repair: each decode reads only unit 2's
    group), unit 0 down (in a short group, a local repair over known-zero
    units) and units 0 and 1 down (global decode), a rebuild of replica
    index 3 (unit 2) of every container onto a spare, then the device
    scrubber over the datanodes."""
    from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader
    from ozone_tpu_torch.codec import fused_kernel, lrc_math
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.storage.reconstruction import (
        ECReconstructionCoordinator,
        ReconstructionCommand,
    )

    opts = CoderOptions.parse(f"lrc-12-2-2-{cell}")
    rng = np.random.default_rng(seed + 3)
    keys = [rng.integers(0, 256, n, dtype=np.uint8) for n in key_sizes]
    out = {}
    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-lrc-") as tmp:
        cluster = Cluster(Path(tmp), opts, 18)
        try:
            before = service_counts()
            fused_kernel.launches.reset()
            t0 = time.perf_counter()
            groups_per_key, writers = put_keys(cluster, keys, device, bpc)
            put_s = time.perf_counter() - t0
            out["put_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            groups = [g for gs in groups_per_key for g in gs]
            checked = verify_keys(cluster, keys, groups_per_key, device, bpc, seed, 64)
            print(f"lrc: lrc-12-2-2 PUT of {len(keys)} keys, {sum(key_sizes)} B in "
                  f"{put_s:.3f} s = {sum(key_sizes) / put_s / 2**30:.3f} GiB/s (wall), "
                  f"{len(groups)} block groups on 16 of 18 datanodes; encode launches "
                  f"{out['put_launches']} for {svc['dispatches']} service dispatches of "
                  f"{sum(w.dispatches for w in writers)} writer submissions; "
                  f"{checked['chunks']} chunks equal the source and the plain version")
            if device.type == "cuda" and (out["put_launches"] <= 0
                                          or out["put_launches"] != svc["dispatches"]):
                raise AssertionError("lrc PUT: launches differ from service dispatches")

            fused_kernel.launches.reset()
            healthy = read_groups(cluster, keys, groups_per_key, device, bpc)
            print(f"lrc healthy GET: {healthy['bytes'] / healthy['wall_s'] / 2**30:.3f} "
                  f"GiB/s (wall), decode launches {fused_kernel.launches.count}")
            if fused_kernel.launches.count or healthy["dispatches"]:
                raise AssertionError("a healthy lrc read decoded")

            nodes = groups[0].pipeline.nodes
            scope = {nodes[u] for u in lrc_math.group_scope(opts, 0)} - {nodes[2]}
            out["local"] = degraded_lrc_get(cluster, keys, groups_per_key, device, bpc,
                                            [2], "local")
            cluster.dead = {nodes[2]}
            for g in groups:
                reader = ECBlockGroupReader(g, opts, cluster.clients,
                                            bytes_per_checksum=bpc, device=device)
                with spy_reads(cluster) as served:
                    reader.recover_cells([2])
                if not set(served) <= scope or (g.length >= 12 * cell
                                                and len(served) != 6):
                    raise AssertionError(f"local repair of unit 2 in {g.block_id} read "
                                         f"{sorted(served)}, not its group {sorted(scope)}")
            cluster.dead = set()
            print(f"lrc local repair: every decode of unit 2 read only the datanodes of "
                  f"its group ({len(scope)})")
            out["short"] = degraded_lrc_get(cluster, keys, groups_per_key, device, bpc,
                                            [0], "local (unit 0, short group over "
                                            "known-zero units)")
            out["global"] = degraded_lrc_get(cluster, keys, groups_per_key, device, bpc,
                                             [0, 1], "global")

            cluster.dead = {nodes[2]}
            coord = ECReconstructionCoordinator(cluster.clients, bytes_per_checksum=bpc,
                                                device=device)
            cmds = [ReconstructionCommand(
                g.container_id, opts,
                {u + 1: n for u, n in enumerate(g.pipeline.nodes) if u != 2},
                {3: "dn16"}) for g in groups]
            before = service_counts()
            fused_kernel.launches.reset()
            with spy_reads(cluster) as served:
                t0 = time.perf_counter()
                for cmd in cmds:
                    coord.reconstruct_container_group(cmd)
                repair_s = time.perf_counter() - t0
            out["repair_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            rebuilt = check_rebuilt(cluster, groups, [2], ["dn16"], bpc)
            target = rebuilt["per_target"]["dn16"]
            read_bytes = sum(served.values())
            print(f"lrc repair: {len(cmds)} containers, replica index 3 onto dn16 in "
                  f"{repair_s:.3f} s: {target / repair_s / MIB:.1f} MiB/s per target "
                  f"datanode (wall), {target} B rebuilt; {read_bytes} B read from "
                  f"{len(served)} datanodes = {read_bytes / target:.3f} B read per rebuilt "
                  f"B; {rebuilt['chunks']} rebuilt chunks ({rebuilt['partial']} partial) "
                  f"equal the lost ones, CRCs equal host CRC32C")
            if not set(served) <= scope:
                raise AssertionError(f"the repair read {sorted(served)}, outside unit 2's "
                                     "group")
            check_launches("lrc repair", device, out["repair_launches"], svc,
                           coord.metrics.counter("decode_dispatches").value)
            cluster.dead = set()
            out.update(repair_mib_s_per_target=target / repair_s / MIB,
                       read_per_rebuilt=read_bytes / target)
            out["scrub"] = scrub_path(cluster, device, groups)
        finally:
            cluster.close()
    out["decode_launches"] = sum(out[k]["launches"] for k in ("local", "short", "global")) \
        + out["repair_launches"]
    return out


def scrub_path(cluster: Cluster, device, groups) -> dict:
    """Close every container, scrub every datanode on the device (no
    errors), then flip one byte of one chunk file: the scrubber reports
    exactly that slice, the replica goes UNHEALTHY, and the host scan names
    the same chunk."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.storage.ids import ContainerState
    from ozone_tpu_torch.storage.scrubber import SCANNABLE_STATES, DeviceScrubber

    scrubbed = 0
    for dn in cluster.dns.values():
        for c in dn.list_containers():
            if c.state is ContainerState.OPEN:
                dn.close_container(c.id)
            if c.state in SCANNABLE_STATES:
                scrubbed += sum(i.length for b in c.list_blocks() for i in b.chunks)
    scrubber = DeviceScrubber(device=device)
    fused_kernel.launches.reset()
    t0 = time.perf_counter()
    found = {dn_id: scrubber.scrub_all(dn) for dn_id, dn in cluster.dns.items()}
    wall = time.perf_counter() - t0
    launches = fused_kernel.launches.count
    print(f"scrub: {len(cluster.dns)} datanodes, {scrubbed} B of chunks in {wall:.3f} s = "
          f"{scrubbed / wall / 2**30:.3f} GiB/s (wall); kernel launches {launches}, "
          f"scrub dispatches {scrubber.dispatches}")
    if any(found.values()):
        raise AssertionError(f"the scrubber found errors in healthy containers: {found}")
    if device.type == "cuda" and (launches <= 0 or launches != scrubber.dispatches):
        raise AssertionError(f"scrub: {launches} kernel launches for "
                             f"{scrubber.dispatches} dispatches")

    g = max(groups, key=lambda grp: grp.length)
    dn = cluster.dns[g.pipeline.nodes[5]]
    info = dn.get_block(g.block_id).chunks[3]
    bpc = info.checksum.bytes_per_checksum
    sl = min(7, info.length // bpc - 1)
    path = dn.containers.get(g.container_id).chunks.block_path(g.block_id)
    with open(path, "r+b") as f:
        f.seek(info.offset + sl * bpc + 100)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0x5A]))
    errors = scrubber.scrub_container(dn, g.container_id)
    want = f"{g.block_id}/{info.name}: crc mismatch at slice {sl}"
    state = dn.containers.get(g.container_id).state
    host = dn.scan_container(g.container_id)
    print(f"scrub of one flipped byte: {errors}; container {state.value}; host scan: {host}")
    if errors != [want] or state is not ContainerState.UNHEALTHY:
        raise AssertionError(f"scrub reported {errors} ({state.value}), want [{want!r}]")
    if [e.split(":")[0] for e in host] != [want.split(":")[0]]:
        raise AssertionError(f"the host scan reported {host}")
    return {"launches": launches, "gib_s": scrubbed / wall / 2**30,
            "dispatches": scrubber.dispatches}


def kill_datanode(cluster, dn_id: str) -> None:
    """Stop a datanode (its client raises, it heartbeats no more) and let
    the SCM's liveness sweep find it dead."""
    from ozone_tpu_torch.scm.node_manager import NodeState

    cluster.stop_datanode(dn_id)
    cluster.scm.nodes.get(dn_id).last_heartbeat = -1e9
    cluster.scm.nodes.check_liveness()
    if cluster.scm.nodes.get(dn_id).state is not NodeState.DEAD:
        raise AssertionError(f"the SCM does not see {dn_id} dead")


def ec_missing(cluster) -> dict:
    """{container id: missing replica indexes} of every closed EC container,
    as the SCM's replica reports show them (read only: no commands)."""
    from ozone_tpu_torch.scm.pipeline import ReplicationType
    from ozone_tpu_torch.scm.replication_manager import ECReplicaCount
    from ozone_tpu_torch.storage.ids import ContainerState

    out = {}
    for c in cluster.scm.containers.containers():
        if c.replication.type is ReplicationType.EC and c.state in (
                ContainerState.CLOSED, ContainerState.QUASI_CLOSED):
            missing = ECReplicaCount(c, cluster.scm.nodes).missing_indexes
            if missing:
                out[c.id] = missing
    return out


def revive_datanode(cluster, dn_id: str) -> None:
    cluster.restart_datanode(dn_id)
    cluster.tick()


def reencode(cluster, device, what: str, volume: str, bucket: str, key: str,
             ec: str, size: int) -> dict:
    """One re-encode through `client/re_encode.py` on the codec service:
    MiB/s of user data (wall), and kernel launches against the service's
    dispatches in the run."""
    from ozone_tpu_torch.client.re_encode import re_encode_key_to_ec
    from ozone_tpu_torch.codec import fused_kernel

    before = service_counts()
    fused_kernel.launches.reset()
    since, t0 = time.time(), time.perf_counter()
    info = re_encode_key_to_ec(cluster.om, cluster.clients, volume, bucket, key,
                               ec=ec, device=device)
    wall = time.perf_counter() - t0
    launches = fused_kernel.launches.count
    svc = service_delta(before)
    print(f"{what} spans: {span_totals(since)}")
    print(f"{what}: {size} B to {info['replication']} in {wall:.3f} s = "
          f"{size / wall / MIB:.1f} MiB/s of user data (wall), "
          f"{len(info['block_groups'])} groups; kernel launches {launches}, service "
          f"dispatches {svc['dispatches']} of {svc['submissions']} submissions")
    if info["size"] != size or info["replication"] != ec:
        raise AssertionError(f"{what}: key info {info['size']} B {info['replication']}")
    if device.type == "cuda" and (launches <= 0 or launches != svc["dispatches"]):
        raise AssertionError(f"{what}: {launches} kernel launches for "
                             f"{svc['dispatches']} service dispatches")
    return {"launches": launches, "dispatches": svc["dispatches"],
            "mib_s": size / wall / MIB}


def control_plane_path(device, cell: int, bpc: int, seed: int) -> dict:
    """The control plane on the codec service: a MiniOzoneCluster of 12
    datanodes on 3 racks (SCM with rack-scatter placement, OM on sqlite),
    blocks of 16 cells. Through OzoneClient: an xor-6-1 key of three full
    groups and a short one, a RATIS/THREE key of one group and 7 B, and a
    second xor-6-1 key of one group and 12 345 B. Then the replicated key
    is re-encoded to rs-6-3, the first XOR key with unit 2's datanode down
    (the fused re-encode), the second with its parity's datanode down (a
    plain encode); every key is re-read byte-exact through OzoneClient.
    Last, every container is closed, one datanode of the RS groups dies,
    and ticks run until the SCM's reconstruction commands have rebuilt
    its replicas onto spares; the rebuilt chunks must equal the lost ones
    and the keys must read back byte-exact."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.storage.ids import BlockID, ContainerState, StorageError
    from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster
    from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

    block = 16 * cell
    rs, xor = f"rs-6-3-{cell // 1024}k", f"xor-6-1-{cell // 1024}k"
    rng = np.random.default_rng(seed + 4)
    sizes = {"x1": 3 * 6 * block + 12345, "rep": 6 * block + 7,
             "x2": 6 * block + 12345}
    data = {k: rng.integers(0, 256, n, dtype=np.uint8) for k, n in sizes.items()}
    out: dict = {}
    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-cp-") as tmp:
        cluster = MiniOzoneCluster(Path(tmp), num_datanodes=12, racks=3, block_size=block,
                                   container_size=16 * block, stale_after_s=1e6,
                                   dead_after_s=2e6, placement_seed=seed, device=device)
        try:
            oz = cluster.client()
            vol = oz.create_volume("v")
            buckets = {"x1": vol.create_bucket("xor", replication=xor),
                       "rep": vol.create_bucket("rep", replication="RATIS/THREE"),
                       "x2": vol.create_bucket("xor2", replication=xor)}
            before = service_counts()
            fused_kernel.launches.reset()
            t0 = time.perf_counter()
            for name, b in buckets.items():
                b.write_key("k", data[name])
            put_s = time.perf_counter() - t0
            out["put_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            print(f"control plane: 12 datanodes on 3 racks; PUT of {sum(sizes.values())} B "
                  f"({xor} {sizes['x1']} B, RATIS/THREE {sizes['rep']} B, {xor} "
                  f"{sizes['x2']} B) through OzoneClient in {put_s:.3f} s; XOR encode "
                  f"launches {out['put_launches']} for {svc['dispatches']} service "
                  f"dispatches")
            if device.type == "cuda" and out["put_launches"] != svc["dispatches"]:
                raise AssertionError("XOR PUT: launches differ from service dispatches")

            out["reencode_replicated"] = reencode(
                cluster, device, "re-encode RATIS/THREE -> rs-6-3", "v", "rep", "k", rs,
                sizes["rep"])
            x1 = oz.om.lookup_key("v", "xor", "k")
            victim = {g["nodes"][2] for g in x1["block_groups"]}
            for dn_id in victim:
                kill_datanode(cluster, dn_id)
            out["reencode_xor"] = reencode(
                cluster, device, f"re-encode {xor} -> rs-6-3, unit 2 down {sorted(victim)}",
                "v", "xor", "k", rs, sizes["x1"])
            for dn_id in victim:
                revive_datanode(cluster, dn_id)
            x2 = oz.om.lookup_key("v", "xor2", "k")
            victim = {g["nodes"][6] for g in x2["block_groups"]}
            for dn_id in victim:
                kill_datanode(cluster, dn_id)
            out["reencode_xor_parity_lost"] = reencode(
                cluster, device, f"re-encode {xor} -> rs-6-3, XOR parity down "
                f"{sorted(victim)}", "v", "xor2", "k", rs, sizes["x2"])
            for dn_id in victim:
                revive_datanode(cluster, dn_id)
            for name, b in buckets.items():
                if not np.array_equal(b.read_key("k"), data[name]):
                    raise AssertionError(f"re-read of {name} differs from the source")
                off, n = sizes[name] // 3, sizes[name] // 2
                if not np.array_equal(b.read_key_range("k", off, n),
                                      data[name][off:off + n]):
                    raise AssertionError(f"ranged re-read of {name} differs")
            print("control plane: every re-encoded key re-read byte-exact through "
                  "OzoneClient (whole and ranged)")
            # the old versions retire through the SCM's deletion chain
            purged = cluster.om.run_key_deleting_service_once()
            cluster.tick(rounds=2)
            if purged != 3 or cluster.scm.deleted_blocks.pending_count():
                raise AssertionError(f"purge: {purged} keys, "
                                     f"{cluster.scm.deleted_blocks.pending_count()} pending")

            # SCM-driven repair: close everything, one RS datanode dies
            for dn in cluster.datanodes:
                for c in dn.list_containers():
                    if c.state is ContainerState.OPEN:
                        dn.close_container(c.id)
            cluster.tick()
            infos = {name: oz.om.lookup_key("v", b.name, "k") for name, b in buckets.items()}
            groups = [g for info in infos.values() for g in info["block_groups"]]
            victim = groups[0]["nodes"][0]
            lost = {}  # BlockID -> (unit, [(ChunkInfo, bytes)])
            vdn = cluster.datanode(victim)
            for g in groups:
                if victim in g["nodes"]:
                    bid = BlockID(int(g["container_id"]), int(g["local_id"]))
                    try:
                        chunks = vdn.get_block(bid).chunks
                    except StorageError:  # a unit holding no bytes of a short group
                        chunks = []
                    lost[bid] = (g["nodes"].index(victim),
                                 [(c, vdn.read_chunk(bid, c)) for c in chunks])
            kill_datanode(cluster, victim)
            before = service_counts()
            fused_kernel.launches.reset()
            since, t0 = time.time(), time.perf_counter()
            ticks = 0
            while True:
                cluster.tick()
                cluster.heartbeat_all()  # the rebuilt replicas report
                ticks += 1
                missing = ec_missing(cluster)
                if not missing or ticks >= 5:
                    break
            repair_s = time.perf_counter() - t0
            out["repair_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            print(f"SCM repair spans: {span_totals(since)}")
            if missing:
                raise AssertionError(f"after {ticks} ticks, replicas still missing: {missing}")
            host = Checksum(ChecksumType.CRC32C, bpc)
            per_target: dict[str, int] = {}
            n_chunks = 0
            for bid, (u, chunks) in lost.items():
                cinfo = cluster.scm.containers.get(bid.container_id)
                holders = [dn for dn, r in cinfo.replicas.items() if r.replica_index == u + 1]
                if len(holders) != 1 or holders[0] == victim:
                    raise AssertionError(f"{bid} replica index {u + 1}: {holders}")
                dst = cluster.datanode(holders[0])
                c = dst.containers.get(bid.container_id)
                if c.state is not ContainerState.CLOSED:
                    raise AssertionError(f"rebuilt container {bid.container_id} is "
                                         f"{c.state.value}")
                rebuilt = dst.get_block(bid).chunks if chunks else []
                if [(i.offset, i.length) for i, _ in chunks] != \
                        [(i.offset, i.length) for i in rebuilt]:
                    raise AssertionError(f"rebuilt chunk list of {bid} differs")
                for (_, want), info in zip(chunks, rebuilt):
                    got = dst.read_chunk(bid, info)
                    if not np.array_equal(got, want):
                        raise AssertionError(f"rebuilt chunk {info.name} differs")
                    if host.compute(got).checksums != info.checksum.checksums:
                        raise AssertionError(f"stored CRCs of rebuilt {info.name} != host")
                    per_target[holders[0]] = per_target.get(holders[0], 0) + info.length
                    n_chunks += 1
            rebuilt_mib_s = {t: n / repair_s / MIB for t, n in per_target.items()}
            print(f"SCM repair: {victim} dead; {len(lost)} blocks of its replicas rebuilt onto "
                  f"{sorted(per_target)} by the replication manager's commands in {ticks} "
                  f"ticks, {repair_s:.3f} s: " + ", ".join(
                      f"{t} {per_target[t]} B = {r:.1f} MiB/s" for t, r in
                      sorted(rebuilt_mib_s.items())) + " per target (wall); "
                  f"{n_chunks} rebuilt chunks equal the lost ones, CRCs equal host CRC32C; "
                  f"decode launches {out['repair_launches']}, service dispatches "
                  f"{svc['dispatches']}")
            if device.type == "cuda" and (out["repair_launches"] <= 0
                                          or out["repair_launches"] != svc["dispatches"]):
                raise AssertionError(f"SCM repair: {out['repair_launches']} kernel launches "
                                     f"for {svc['dispatches']} service dispatches")
            if not per_target:
                raise AssertionError("the SCM repair rebuilt no bytes")
            before = service_counts()
            fused_kernel.launches.reset()
            for name, b in buckets.items():
                if not np.array_equal(b.read_key("k"), data[name]):
                    raise AssertionError(f"re-read of {name} after the repair differs")
            out["degraded_launches"] = fused_kernel.launches.count
            check_launches_equal("re-read with the victim down", device,
                                 out["degraded_launches"], service_delta(before))
            print("control plane: every key re-read byte-exact with the dead datanode "
                  "still down")
            out["repair_mib_s_per_target"] = rebuilt_mib_s
        finally:
            cluster.close()
    return out


# ------------------------------------------------------- raw coder SPI
def check_coder_forms(device, cell: int, seed: int) -> dict:
    """The raw coder SPI's two forms of the kernel (no CRC rows) against
    their plain versions, exact: the matrix apply (`torch_coder.gf_apply`)
    with the RS(6,3) generator at cells of 1, 100 and 4097 B and `cell`,
    and an RS(10,4) [4, 10] decode (units 0-3 from units 4-13), which must
    also give the erased units; the XOR reduce (`torch_coder.xor_reduce`)
    over k = 3, 6 and 10 units. Returns the largest difference per form."""
    from ozone_tpu_torch.codec import rs_math, torch_coder
    from ozone_tpu_torch.codec.fused_kernel import gf_apply_plain

    rng = np.random.default_rng(seed + 7)
    worst = {"gf_apply": 0, "xor_reduce": 0}

    def data(b, k, c):
        return torch.from_numpy(rng.integers(0, 256, (b, k, c), dtype=np.uint8)).to(device)

    def compare(form, name, got, want):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        diff = (got.int() - want.int()).abs().max().item()
        print(f"{form} kernel vs plain {name}: max_abs_err={diff} out={tuple(got.shape)}")
        if diff or got.shape != want.shape:
            raise AssertionError(f"{form} kernel disagrees with plain on {name}")
        worst[form] = max(worst[form], diff)

    pm = torch.from_numpy(rs_math.parity_matrix(6, 3)).to(device)
    for c, b in ((1, 8), (100, 8), (4097, 4), (cell, 8)):
        x = data(b, 6, c)
        compare("gf_apply", f"rs-6-3 [3, 6] cell={c} B={b} slice="
                f"{torch_coder.apply_slice(c)}", torch_coder.gf_apply(x, pm),
                gf_apply_plain(x, pm))
    x = data(8, 10, cell)
    units = torch.cat([x, gf_apply_plain(x, torch.from_numpy(
        rs_math.parity_matrix(10, 4)).to(device))], 1)
    valid, erased = list(range(4, 14)), [0, 1, 2, 3]
    dm = torch.from_numpy(rs_math.decode_matrix(10, 4, erased, valid)).to(device)
    inputs = units[:, valid].contiguous()
    rec = torch_coder.gf_apply(inputs, dm)
    compare("gf_apply", f"rs-10-4 decode [4, 10] erased={erased} cell={cell} B=8",
            rec, gf_apply_plain(inputs, dm))
    if not torch.equal(rec, units[:, erased]):
        raise AssertionError("the RS(10,4) decode does not give the erased units")
    for k in (3, 6, 10):
        x = data(8, k, cell)
        compare("xor_reduce", f"[1, {k}] cell={cell} B=8", torch_coder.xor_reduce(x),
                torch_coder.xor_reduce_plain(x))
    return worst


def time_coder_forms(device, cell: int, seed: int) -> dict:
    """The two SPI forms at the rawcoder bench's RS(6,3) shape, B=8: the
    matrix apply [3, 6] (bound: 48 + 24 MiB moved at 1 MiB cells) and the
    XOR reduce [1, 6] (48 + 8 MiB)."""
    from ozone_tpu_torch.codec import rs_math, torch_coder
    from ozone_tpu_torch.codec.fused_kernel import gf_apply_plain

    rng = np.random.default_rng(seed + 8)
    b = 8
    x = torch.from_numpy(rng.integers(0, 256, (b, 6, cell), dtype=np.uint8)).to(device)
    pm = torch.from_numpy(rs_math.parity_matrix(6, 3)).to(device)
    out = {}
    for form, p, run, plain in (
            ("gf_apply", 3, lambda: torch_coder.gf_apply(x, pm),
             lambda: gf_apply_plain(x, pm)),
            ("xor_reduce", 1, lambda: torch_coder.xor_reduce(x),
             lambda: torch_coder.xor_reduce_plain(x))):
        bound = fused_bound(b, 6, p, cell, cell, rows=0)
        out[form] = {**time_form(f"{form} [{p}, 6] (no CRC rows) cell={cell} B={b}",
                                 run, plain, bound, b * 6 * cell),
                     "bound_by": bound[1]}
    print("library_ms: none for gf_apply and xor_reduce; no single PyTorch call "
          "computes a GF(2^8) matrix product, and torch has no bitwise-XOR reduction")
    return out


def rawcoder_phase(device, cell: int) -> dict:
    """freon's rawcoder_bench at B=8: rs-6-3 and rs-10-4 for the torch,
    cpp and numpy coders, xor-6-1 for torch and numpy (numpy one timed
    call, the others three). Fails on an "error" row; the registry must
    answer torch, cpp, numpy for rs, the cpp coder must be the AVX2 build,
    kernel launches must equal the torch coder's calls, and the torch
    coder's parity and decoded units must equal numpy's."""
    from ozone_tpu_torch.codec import (
        CoderOptions,
        cpp_coder,
        create_decoder,
        create_encoder,
        fused_kernel,
        torch_coder,
    )
    from ozone_tpu_torch.codec.registry import CodecRegistry
    from ozone_tpu_torch.tools import freon

    reg = CodecRegistry.instance()
    probe = cpp_coder.probe()
    print(f"coder registry: rs {reg.backends('rs')}, xor {reg.backends('xor')}, "
          f"lrc {reg.backends('lrc')}, dummy {reg.backends('dummy')}; "
          f"cpp coder probe {probe} (2 = AVX2 nibble shuffle, 0 = scalar loop)")
    if reg.backends("rs") != ["torch", "cpp", "numpy"]:
        raise AssertionError(f"registry order for rs: {reg.backends('rs')}")
    if probe < 2:
        raise AssertionError("the cpp coder is not the AVX2 build")
    enc = create_encoder(CoderOptions(6, 3, "rs", cell), device=device)
    before = fused_kernel.launches.count
    enc.encode(np.zeros((1, 6, cell), dtype=np.uint8))
    if not isinstance(enc, torch_coder.TorchRSEncoder) or (
            device.type == "cuda" and fused_kernel.launches.count - before != 1):
        raise AssertionError(f"the registry's default rs encoder ({type(enc).__name__}) "
                             "did not launch the kernel")

    runs = (("rs-6-3", ["torch", "cpp"], 3), ("rs-6-3", ["numpy"], 1),
            ("rs-10-4", ["torch", "cpp"], 3), ("rs-10-4", ["numpy"], 1),
            ("xor-6-1", ["torch"], 3), ("xor-6-1", ["numpy"], 1))
    calls = {"gf_apply": 0, "xor_reduce": 0}
    fused_kernel.launches.reset()
    torch_coder.apply_launches.reset()
    torch_coder.xor_launches.reset()
    rows = []
    for schema, backends, iters in runs:
        rows += freon.rawcoder_bench(backends, schema, cell, 8, iters, device=device)
        if "torch" in backends:  # a warm-up and `iters` calls, each way
            calls["xor_reduce" if schema.startswith("xor") else "gf_apply"] += 2 * (iters + 1)
    out = {"rows": rows, "launches": fused_kernel.launches.count,
           "gf_apply_launches": torch_coder.apply_launches.count,
           "xor_reduce_launches": torch_coder.xor_launches.count}
    for r in rows:
        print(f"rawcoder_bench cell={cell} B=8: {json.dumps(r)}")
    if any("error" in r for r in rows):
        raise AssertionError("a rawcoder_bench row failed")
    print(f"rawcoder_bench: kernel launches {out['launches']} (gf_apply "
          f"{out['gf_apply_launches']}, xor_reduce {out['xor_reduce_launches']}) for "
          f"torch coder calls {calls}")
    if device.type == "cuda" and (
            out["gf_apply_launches"] != calls["gf_apply"]
            or out["xor_reduce_launches"] != calls["xor_reduce"]
            or out["launches"] != sum(calls.values())):
        raise AssertionError("rawcoder_bench: kernel launches differ from the torch "
                             "coder's calls")
    for schema in ("rs-6-3", "rs-10-4", "xor-6-1"):
        codec, k, p = schema.split("-")
        opts = CoderOptions(int(k), int(p), codec, cell)
        data = np.random.default_rng(2).integers(0, 256, (8, opts.data_units, cell),
                                                 dtype=np.uint8)
        parity = create_encoder(opts, "numpy").encode(data)
        if not np.array_equal(create_encoder(opts, "torch", device).encode(data), parity):
            raise AssertionError(f"{schema}: torch parity differs from numpy's")
        units = np.concatenate([data, parity], axis=1)
        erased = list(range(min(2, opts.parity_units)))
        inputs = [None if i in erased else units[:, i] for i in range(opts.all_units)]
        got = create_decoder(opts, "torch", device).decode(inputs, erased)
        if not (np.array_equal(got, create_decoder(opts, "numpy").decode(inputs, erased))
                and np.array_equal(got, units[:, erased])):
            raise AssertionError(f"{schema}: torch decode differs from numpy's")
    print("rawcoder_bench: torch parity and decoded units equal numpy's (rs-6-3, "
          "rs-10-4, xor-6-1)")
    return out


def freon_path(device, cell: int, bpc: int, seed: int) -> dict:
    """Freon's EC generators and the reconstruction storm, on the codec
    service, after the rawcoder bench: a MiniOzoneCluster of 12 datanodes
    on 3 racks, rs-6-3 at `cell`, CRC32C over bpc, blocks of 16 cells and
    containers of three blocks.
    - ockg: 48 keys of one block (8 threads, one warm-up key), then ockv
      over all 48 and ockrr with 64 ranged reads of one cell; no failures,
      launches = service dispatches;
    - ecrd: a key of 64 cells, 3 rounds (freon's defaults at 1 MiB);
    - the storm: every container closed, the datanode with the most
      closed EC containers (at least 8) dies (the SCM's liveness sweep
      declares it DEAD), and `ReconstructionStorm.repair_datanode` rebuilds
      all of them; every rebuilt chunk must equal the lost one, with
      stored CRCs equal to the host CRC32C, and launches = dispatches."""
    from ozone_tpu_torch.client.reconstruction import ReconstructionStorm
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.scm.pipeline import ReplicationType
    from ozone_tpu_torch.storage.ids import ContainerState
    from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster
    from ozone_tpu_torch.tools import freon
    from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

    out = {"rawcoder": rawcoder_phase(device, cell)}
    block = 16 * cell
    ec = f"rs-6-3-{cell // 1024}k"
    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-freon-") as tmp:
        cluster = MiniOzoneCluster(Path(tmp), num_datanodes=12, racks=3, block_size=block,
                                   container_size=3 * block, stale_after_s=1e6,
                                   dead_after_s=2e6, placement_seed=seed, device=device)
        try:
            oz = cluster.client()

            def generator(what, run):
                before = service_counts()
                fused_kernel.launches.reset()
                rep = run()
                launches = fused_kernel.launches.count
                check_launches_equal(what, device, launches, service_delta(before))
                if isinstance(rep, dict):
                    print(f"{what}: {json.dumps(rep)}")
                    return rep, launches
                summary = {k: v for k, v in rep.summary().items() if k != "histogram"}
                print(f"{what}: {json.dumps(summary)}")
                if rep.failures or not rep.ops:
                    raise AssertionError(f"{what}: {rep.failures} failures of {rep.ops}")
                return summary, launches

            out["ockg"], out["ockg_launches"] = generator(
                f"ockg 48 keys of {block} B {ec}, 8 threads", lambda: freon.ockg(
                    oz, n_keys=48, size=block, threads=8, replication=ec, warmup=1))
            out["ockv"], out["ockv_launches"] = generator(
                "ockv 48 keys", lambda: freon.ockv(oz, n_keys=48, size=block, threads=8))
            out["ockrr"], out["ockrr_launches"] = generator(
                f"ockrr 64 reads of {cell} B", lambda: freon.ockrr(
                    oz, 64, threads=8, size=cell, n_keys=48))
            out["ecrd"], out["ecrd_launches"] = generator(
                f"ecrd {64 * cell} B, 3 rounds", lambda: freon.ecrd(
                    oz, cluster.scm, size=64 * cell, rounds=3, replication=ec))
            print(f"ecrd: reconstruct_mib_s_per_datanode "
                  f"{out['ecrd']['reconstruct_mib_s_per_datanode']}")

            # the storm: close every container, let the SCM see the reports
            for dn in cluster.datanodes:
                for c in dn.list_containers():
                    if c.state is ContainerState.OPEN:
                        dn.close_container(c.id)
            cluster.tick()
            cluster.heartbeat_all()
            held: dict[str, list] = {}
            for c in cluster.scm.containers.containers():
                if c.replication.type is ReplicationType.EC \
                        and c.state is ContainerState.CLOSED:
                    for dn_id in c.replicas:
                        held.setdefault(dn_id, []).append(c)
            victim = max(sorted(held), key=lambda d: len(held[d]))
            if len(held[victim]) < 8:
                raise AssertionError(f"{victim} holds {len(held[victim])} closed EC "
                                     "containers; the storm needs 8")
            vdn = cluster.datanode(victim)
            lost = {}  # container id -> (replica index, [(BlockID, [(ChunkInfo, bytes)])])
            for c in held[victim]:
                lost[c.id] = (c.replicas[victim].replica_index, [
                    (bd.block_id, [(i, vdn.read_chunk(bd.block_id, i)) for i in bd.chunks])
                    for bd in vdn.list_blocks(c.id)])
            kill_datanode(cluster, victim)
            storm = ReconstructionStorm(cluster.scm, cluster.clients, device=device)
            plans: list = []
            plan = storm.plan
            storm.plan = lambda dn_id: plans.append(plan(dn_id)) or plans[-1]
            before = service_counts()
            fused_kernel.launches.reset()
            since = time.time()
            report = storm.repair_datanode(victim)
            out["storm_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            print(f"storm spans: {span_totals(since)}")
            planned = {cmd.container_id: cmd for cmd in plans[0]}
            print(f"storm plan: {len(planned)} containers, {len(lost)} closed ones held "
                  f"by {victim}: " + ", ".join(
                      f"{cid} {sorted(cmd.targets.items())}" for cid, cmd in
                      sorted(planned.items())))
            if not report.ok or report.containers_repaired != report.containers_planned \
                    or set(lost) != set(planned):
                raise AssertionError(f"storm: {report}")
            host = Checksum(ChecksumType.CRC32C, bpc)
            per_target: dict[str, int] = {}
            n_chunks = 0
            for cmd in plans[0]:
                idx, blocks = lost[cmd.container_id]
                target = cmd.targets[idx]
                dst = cluster.datanode(target)
                c = dst.containers.get(cmd.container_id)
                if c.state is not ContainerState.CLOSED or c.replica_index != idx:
                    raise AssertionError(f"rebuilt container {cmd.container_id} on {target}"
                                         f" is {c.state.value}, index {c.replica_index}")
                for bid, chunks in blocks:
                    rebuilt = dst.get_block(bid).chunks
                    if [(i.offset, i.length) for i, _ in chunks] != \
                            [(i.offset, i.length) for i in rebuilt]:
                        raise AssertionError(f"rebuilt chunk list of {bid} differs")
                    for (_, want), info in zip(chunks, rebuilt):
                        got = dst.read_chunk(bid, info)
                        if not np.array_equal(got, want):
                            raise AssertionError(f"rebuilt chunk {info.name} differs")
                        if host.compute(got).checksums != info.checksum.checksums:
                            raise AssertionError(f"stored CRCs of rebuilt {info.name} "
                                                 "!= host CRC32C")
                        per_target[target] = per_target.get(target, 0) + info.length
                        n_chunks += 1
            mib_s = {t: n / report.elapsed_s / MIB for t, n in sorted(per_target.items())}
            print(f"storm: {victim} dead; {report.containers_repaired} of "
                  f"{report.containers_planned} planned containers repaired in "
                  f"{report.elapsed_s:.3f} s, {n_chunks} rebuilt chunks equal the lost "
                  f"ones, CRCs equal host CRC32C; " + ", ".join(
                      f"{t} {per_target[t]} B = {r:.1f} MiB/s" for t, r in mib_s.items())
                  + f" per target, {sum(per_target.values()) / report.elapsed_s / MIB:.1f} "
                  f"MiB/s in all; decode launches {out['storm_launches']}, service "
                  f"dispatches {svc['dispatches']} of {svc['submissions']} submissions, "
                  f"multi_op_dispatches {svc['multi_op_dispatches']}")
            if device.type == "cuda" and (out["storm_launches"] <= 0
                                          or out["storm_launches"] != svc["dispatches"]):
                raise AssertionError(f"storm: {out['storm_launches']} kernel launches for "
                                     f"{svc['dispatches']} service dispatches")
            out["storm"] = {"containers": report.containers_repaired,
                            "elapsed_s": report.elapsed_s, "mib_s_per_target": mib_s,
                            "multi_op_dispatches": svc["multi_op_dispatches"],
                            "dispatches": svc["dispatches"]}
        finally:
            cluster.close()
    return out


def check_launches_equal(what: str, device, launches: int, svc: dict) -> None:
    """Every service dispatch of the step was one kernel launch: the
    launches and dispatches read together (service_counts) must agree.
    `launches` is the step's own count since its reset, printed beside."""
    print(f"{what}: kernel launches {launches} ({svc['launches_total']} read with the "
          f"dispatches), service dispatches {svc['dispatches']}")
    if device.type == "cuda" and svc["launches_total"] != svc["dispatches"]:
        raise AssertionError(f"{what}: {svc['launches_total']} kernel launches for "
                             f"{svc['dispatches']} service dispatches")


# ------------------------------------------------------------- daemon path
def stop_server(d) -> None:
    """Stop a daemon's datanode RPC server and its native datapath sidecar."""
    d.server.stop()
    d.stop_datapath()


def restart_server(d) -> None:
    """Serve a daemon's datanode and pipeline-ring verbs again on its old
    port, with a new native sidecar, after stop_server (the registered
    address stays valid; clients discover the sidecar's new port); every
    lane keeps the daemon's token verifier. A mutual-TLS daemon serves
    TLS again, with its CRL, and no sidecar."""
    from ozone_tpu_torch.net.dn_service import DatanodeRpcService
    from ozone_tpu_torch.net.rpc import RpcServer
    from ozone_tpu_torch.storage.fast_datapath import DatapathSidecar

    from ozone_tpu_torch.net.ratis_service import RatisRpcService

    if d.tls is None:  # a mutual-TLS datanode runs no sidecar
        d.datapath = DatapathSidecar(d.dn, verifier=d.verifier)
        d.datapath.start()
    d.server = RpcServer(port=d.server.port, tls=d.tls)
    if d.tls is not None:
        d.server.crl_provider = d.tls.crl
    d.service = DatanodeRpcService(d.dn, d.server, datapath_port=d.advertise,
                                   verifier=d.verifier)
    # its pipeline rings answer again too (their raft state lived on)
    d.ratis_service = RatisRpcService(d.xceiver_ratis, d.server, verifier=d.verifier)
    d.server.start()


LANE_COUNTERS = ("copies", "bytes_copied", "bytes_moved", "native_fallbacks")


class LaneMeter:
    """Deltas across a with-block of the client's `datapath` registry (host
    copies, bytes moved without a copy, native-lane fallbacks) and of the
    daemons' lane counters (native streams, RPC chunk calls, chunks and
    bytes written)."""

    DN_COUNTERS = ("native_write_streams", "native_read_streams",
                   "rpc_chunk_calls", "batched_write_chunks", "batched_read_chunks",
                   "bytes_written")

    def __init__(self, daemons):
        from ozone_tpu_torch.codec import hostmem

        self._reg = hostmem.METRICS
        self._dns = list(daemons)

    def _read(self) -> dict:
        out = {n: self._reg.counter(n).value for n in LANE_COUNTERS}
        for n in self.DN_COUNTERS:
            out[n] = sum(d.dn.metrics.counter(n).value for d in self._dns)
        return out

    def __enter__(self):
        self._v0 = self._read()
        return self

    def __exit__(self, *exc):
        self.d = {k: v - self._v0[k] for k, v in self._read().items()}

    def line(self, chunks_key: str) -> str:
        d = self.d
        chunks = d[chunks_key]
        per = d["copies"] / chunks if chunks else float("nan")
        return (f"native streams w{d['native_write_streams']}/r{d['native_read_streams']}, "
                f"RPC chunk calls {d['rpc_chunk_calls']}, {chunks} chunks, bytes moved "
                f"natively {d['bytes_moved']}, host copies {d['copies']} "
                f"({d['bytes_copied']} B) = {per:.3f} per chunk, native fallbacks "
                f"{d['native_fallbacks']}")


def span_stat(since: float, name: str) -> tuple[int, float]:
    """Count and summed seconds of the tracer's spans `name` since `since`."""
    from ozone_tpu_torch.utils.tracing import Tracer

    spans = [sp for sp in Tracer.instance().traces() if sp.start >= since and sp.name == name]
    return len(spans), sum(sp.duration for sp in spans)


def wait_for(what: str, cond, timeout_s: float, poll_s: float = 0.1) -> float:
    """Poll cond() until true; seconds waited. Raises after timeout_s."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"{what}: not within {timeout_s} s")
        time.sleep(poll_s)
    return time.perf_counter() - t0


def concurrent(fn, items) -> list:
    """fn(item) for every item, each on its own thread, in item order."""
    out: list = [None] * len(items)
    errors: list = []

    def run(i):
        try:
            out[i] = fn(items[i])
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise TimeoutError("a concurrent operation did not finish")
    if errors:
        raise errors[0]
    return out


def daemon_cluster_in_process(device, cell: int, bpc: int, seed: int,
                              in_process_put_gib_s: float) -> dict:
    """One ScmOmDaemon and 12 DatanodeDaemons on loopback on 3 racks, the
    codec on `device`, driven through a remote OzoneClient: the PUT phase's
    four keys concurrently over the native datapath, then the two smaller
    ones again over the RPC lane; a GET over each lane (the RPC lane's of
    the two smaller keys) and in process; a degraded GET with two
    holders' servers and sidecars stopped; an admin close of the
    containers, a datanode's death and the SCM's reconstruction over
    heartbeats; and a scrub of every live daemon's closed containers. The
    native runs must move every chunk over the native lane: no fallback,
    no RPC chunk call, no server-side chunk span."""
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.net.scm_service import RemoteScmClient
    from ozone_tpu_torch.scm.node_manager import NodeState
    from ozone_tpu_torch.storage.ids import BlockID, ContainerState, StorageError
    from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

    rs = f"rs-6-3-{cell // 1024}k"
    rng = np.random.default_rng(seed)
    sizes = [192 * cell, 192 * cell, 96 * cell + 12345, cell + 7]
    keys = [rng.integers(0, 256, n, dtype=np.uint8) for n in sizes]
    total = sum(sizes)
    out: dict = {}

    def no_rpc_chunks(what: str, meter: LaneMeter, since: float, verbs) -> None:
        spans = {v: span_stat(since, f"server:{v}")[0] for v in verbs}
        if meter.d["rpc_chunk_calls"] or any(spans.values()) \
                or meter.d["bytes_moved"] <= 0:
            raise AssertionError(f"{what}: chunk bytes left the native lane: "
                                 f"{meter.d}, server spans {spans}")

    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-dm-") as tmp:
        root = Path(tmp)
        meta = ScmOmDaemon(root / "om.db", block_size=16 * cell,
                           container_size=256 * cell, stale_after_s=3.0,
                           dead_after_s=6.0, background_interval_s=0.5,
                           placement_seed=seed)
        meta.start()
        dns = []
        clients = DatanodeClientFactory()
        om = RemoteOmClient(meta.address, clients=clients)
        rpc_clients = DatanodeClientFactory(native_datapath=False)
        om_rpc = RemoteOmClient(meta.address, clients=rpc_clients)
        scm = RemoteScmClient(meta.address)
        try:
            for i in range(12):
                d = DatanodeDaemon(root / f"dn{i}", f"dn{i}", meta.address,
                                   rack=f"/rack{i % 3}", heartbeat_interval_s=0.5,
                                   device=device)
                d.start()
                dns.append(d)
            by_id = {d.dn.id: d for d in dns}
            wait_for("12 datanodes registered",
                     lambda: len(scm.status()["nodes"]) == 12, 30)
            oz = OzoneClient(om, clients, device=device)
            bucket = oz.create_volume("v").create_bucket("b", replication=rs)
            rpc_bucket = OzoneClient(om_rpc, rpc_clients, device=device).get_volume(
                "v").create_bucket("r", replication=rs)
            names = [f"k{i}" for i in range(len(keys))]
            lanes = [d.advertise() for d in dns]
            if any(not lane or not lane["port"] for lane in lanes):
                raise AssertionError(f"a daemon advertises no native datapath: {lanes}")
            print(f"daemon native datapath: 12 sidecars, ports "
                  f"{[lane['port'] for lane in lanes]}, unix sockets "
                  f"{sum(bool(lane['uds']) for lane in lanes)}")

            # PUT over the native lane, then the same keys over the RPC lane:
            # the client's launches are the service's
            def put_phase(lane: str, bkt, idx: list) -> float:
                before = service_counts()
                fused_kernel.launches.reset()
                nbytes = sum(sizes[i] for i in idx)
                since, t0 = time.time(), time.perf_counter()
                with LaneMeter(dns) as m:
                    concurrent(lambda i: bkt.write_key(names[i], keys[i]), idx)
                put_s = time.perf_counter() - t0
                launches = fused_kernel.launches.count
                svc = service_delta(before)
                print(f"daemon PUT ({lane} lane) spans: {span_totals(since)}")
                print(f"daemon PUT over the {lane} lane: {len(idx)} concurrent {rs} PUTs "
                      f"through a remote OzoneClient into 12 DatanodeDaemons, {nbytes} B in "
                      f"{put_s:.3f} s = {nbytes / put_s / 2**30:.3f} GiB/s (wall), next to "
                      f"{in_process_put_gib_s:.3f} GiB/s for the four keys in process (main "
                      f"path, service route, earlier in this run); kernel launches "
                      f"{launches}, service dispatches {svc['dispatches']}, queue wait "
                      f"{svc['queue_wait_ms']:.3f} ms, dispatch {svc['dispatch_ms']:.3f} ms "
                      f"(means); {m.line('batched_write_chunks')}")
                if device.type == "cuda" and (launches <= 0 or svc["launches_total"]
                                              != svc["dispatches"]):
                    raise AssertionError(f"daemon PUT ({lane}): {svc['launches_total']} "
                                         f"launches for {svc['dispatches']} service "
                                         "dispatches")
                if lane == "native":
                    no_rpc_chunks("daemon PUT (native)", m, since,
                                  ("WriteChunksCommit", "WriteChunk", "StreamWriteBlock"))
                    if m.d["native_fallbacks"] or m.d["bytes_moved"] != m.d["bytes_written"] \
                            or m.d["bytes_moved"] < total:
                        raise AssertionError(f"daemon PUT (native): {m.d}")
                    out["put_launches"] = launches
                    out["put_copies_per_chunk"] = m.d["copies"] / m.d["batched_write_chunks"]
                elif m.d["native_write_streams"] or not m.d["rpc_chunk_calls"]:
                    raise AssertionError(f"daemon PUT (rpc): {m.d}")
                else:
                    out["put_rpc_launches"] = launches
                return nbytes / put_s / 2**30

            # the RPC lane's repeat is cut to the two smaller keys (depth)
            small = [2, 3]
            out["put_gib_s"] = put_phase("native", bucket, list(range(len(keys))))
            out["put_rpc_gib_s"] = put_phase("RPC", rpc_bucket, small)
            infos = [om.lookup_key("v", "b", n) for n in names]
            rpc_infos = [om.lookup_key("v", "r", names[i]) for i in small]
            if [i["size"] for i in infos] != sizes or \
                    [i["size"] for i in rpc_infos] != [sizes[i] for i in small]:
                raise AssertionError(f"daemon PUT: key sizes {[i['size'] for i in infos]}, "
                                     f"{[i['size'] for i in rpc_infos]}")

            # GET over each lane, then the same chunks through in-process clients
            local = DatanodeClientFactory()
            for d in dns:
                local.register_local(d.dn)
            for what, factory in (("over the native lane", clients),
                                  ("over the RPC lane", rpc_clients), ("in process", local)):
                reader = OzoneClient(om, factory, device=device).get_volume(
                    "v").get_bucket("b")
                key = {clients: "native", rpc_clients: "rpc", local: "local"}[factory]
                idx = small if key == "rpc" else list(range(len(keys)))
                nbytes = sum(sizes[i] for i in idx)
                since, t0 = time.time(), time.perf_counter()
                with LaneMeter(dns) as m:
                    got = concurrent(reader.read_key_info, [infos[i] for i in idx])
                get_s = time.perf_counter() - t0
                if not all(np.array_equal(g, keys[i]) for g, i in zip(got, idx)):
                    raise AssertionError(f"daemon GET {what}: bytes differ")
                del got
                out[f"get_gib_s_{key}"] = nbytes / get_s / 2**30
                print(f"daemon GET {what}: {nbytes} B byte-exact in {get_s:.3f} s = "
                      f"{nbytes / get_s / 2**30:.3f} GiB/s (wall); "
                      f"{m.line('batched_read_chunks')}")
                if key == "native":
                    no_rpc_chunks("daemon GET (native)", m, since, ("ReadChunks", "ReadChunk"))
                    if m.d["native_fallbacks"] or m.d["bytes_moved"] < total:
                        raise AssertionError(f"daemon GET (native): {m.d}")
                    out["get_copies_per_chunk"] = m.d["copies"] / max(
                        1, m.d["batched_read_chunks"])

            # degraded GET: two holders' servers and sidecars stop
            g0 = infos[0]["block_groups"][0]
            down = g0["nodes"][:2]
            for dn_id in down:
                stop_server(by_id[dn_id])
            before = service_counts()
            fused_kernel.launches.reset()
            since, t0 = time.time(), time.perf_counter()
            with LaneMeter([d for d in dns if d.dn.id not in down]) as m:
                got = concurrent(bucket.read_key_info, infos)
            deg_s = time.perf_counter() - t0
            out["degraded_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            if not all(np.array_equal(g, k) for g, k in zip(got, keys)):
                raise AssertionError("daemon degraded GET: bytes differ")
            del got
            print(f"daemon degraded GET ({down} servers and sidecars stopped): {total} B "
                  f"byte-exact in {deg_s:.3f} s = {total / deg_s / 2**30:.3f} GiB/s (wall); "
                  f"decode launches {out['degraded_launches']}, service dispatches "
                  f"{svc['dispatches']}; {m.line('batched_read_chunks')}")
            no_rpc_chunks("daemon degraded GET", m, since, ("ReadChunks", "ReadChunk"))
            if device.type == "cuda" and (out["degraded_launches"] <= 0 or
                                          svc["launches_total"] != svc["dispatches"]):
                raise AssertionError("daemon degraded GET: launches differ from dispatches")
            for dn_id in down:
                restart_server(by_id[dn_id])

            # admin close of every container; the replicas report CLOSED
            cids = [c["id"] for c in scm.list_containers()]
            for cid in cids:
                scm.admin("close-container", str(cid))
            waited = wait_for("containers closed", lambda: all(
                c["state"] == "CLOSED" and all(r["state"] == "CLOSED"
                                               for r in c["replicas"])
                for c in scm.list_containers()), 30)
            print(f"daemon admin close: containers {cids} CLOSED on the SCM and on "
                  f"every replica in {waited:.2f} s")

            # one datanode dies; the SCM's commands rebuild its replicas
            victim = g0["nodes"][2]
            vdn = by_id[victim].dn
            lost = {}  # BlockID -> (unit, [(ChunkInfo, bytes)])
            for info in infos + rpc_infos:
                for g in info["block_groups"]:
                    if victim in g["nodes"]:
                        bid = BlockID(int(g["container_id"]), int(g["local_id"]))
                        try:
                            chunks = vdn.get_block(bid).chunks
                        except StorageError:  # no bytes of a short group
                            chunks = []
                        lost[bid] = (g["nodes"].index(victim),
                                     [(c, vdn.read_chunk(bid, c).copy()) for c in chunks])
            by_id[victim].stop()
            dead_s = wait_for(f"{victim} declared dead", lambda: meta.scm.nodes.get(
                victim).state is NodeState.DEAD, 30)
            before = service_counts()
            fused_kernel.launches.reset()
            since, t0 = time.time(), time.perf_counter()
            meter = LaneMeter([d for d in dns if d.dn.id != victim])
            meter.__enter__()

            def rebuilt():
                with meta.scm_service.lock:
                    for bid, (u, _) in lost.items():
                        c = meta.scm.containers.get(bid.container_id)
                        held = [dn for dn, r in c.replicas.items()
                                if r.replica_index == u + 1 and dn != victim
                                and r.state == "CLOSED"]
                        if len(held) != 1:
                            return False
                return True

            wait_for("reconstruction over heartbeats", rebuilt, 60, poll_s=0.05)
            repair_s = time.perf_counter() - t0
            out["repair_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            meter.__exit__()
            print(f"daemon repair spans: {span_totals(since)}")
            print(f"daemon repair reads: {meter.line('batched_read_chunks')}")
            no_rpc_chunks("daemon repair", meter, since, ("ReadChunks", "ReadChunk"))
            if meter.d["native_fallbacks"]:
                raise AssertionError(f"daemon repair: native fallbacks {meter.d}")
            host = Checksum(ChecksumType.CRC32C, bpc)
            per_target: dict[str, int] = {}
            n_chunks = 0
            for bid, (u, chunks) in lost.items():
                c = meta.scm.containers.get(bid.container_id)
                holder = next(dn for dn, r in c.replicas.items()
                              if r.replica_index == u + 1 and dn != victim)
                dst = by_id[holder].dn
                if dst.containers.get(bid.container_id).state is not ContainerState.CLOSED:
                    raise AssertionError(f"rebuilt container {bid.container_id} not CLOSED")
                rebuilt_chunks = dst.get_block(bid).chunks if chunks else []
                if [(i.offset, i.length) for i, _ in chunks] != \
                        [(i.offset, i.length) for i in rebuilt_chunks]:
                    raise AssertionError(f"rebuilt chunk list of {bid} differs")
                for (_, want), info in zip(chunks, rebuilt_chunks):
                    got = dst.read_chunk(bid, info)
                    if not np.array_equal(got, want):
                        raise AssertionError(f"rebuilt chunk {info.name} differs")
                    if host.compute(got).checksums != info.checksum.checksums:
                        raise AssertionError(f"stored CRCs of rebuilt {info.name} != host")
                    per_target[holder] = per_target.get(holder, 0) + info.length
                    n_chunks += 1
            out["repair_mib_s_per_target"] = {t: n / repair_s / MIB
                                              for t, n in per_target.items()}
            print(f"daemon repair: {victim} stopped, DEAD on the SCM after {dead_s:.2f} s; "
                  f"{len(lost)} blocks rebuilt by ReconstructionCommands over heartbeats "
                  f"in {repair_s:.3f} s: " + ", ".join(
                      f"{t} {per_target[t]} B = {r:.1f} MiB/s" for t, r in
                      sorted(out["repair_mib_s_per_target"].items())) +
                  f" per target (wall, from the death); {n_chunks} rebuilt chunks equal "
                  f"the lost ones, CRCs equal host CRC32C; decode launches "
                  f"{out['repair_launches']}, service dispatches {svc['dispatches']}")
            if not per_target:
                raise AssertionError("the daemon repair rebuilt no bytes")
            if any(d.failed_commands for d in dns if d.dn.id != victim):
                raise AssertionError(f"commands failed: "
                                     f"{[d.failed_commands for d in dns]}")
            if device.type == "cuda" and (out["repair_launches"] <= 0 or
                                          svc["launches_total"] != svc["dispatches"]):
                raise AssertionError("daemon repair: launches differ from dispatches")

            # the daemons' scrub of their closed containers
            live = [d for d in dns if d.dn.id != victim]
            scanned = sum(i.length for d in live for c in d.dn.list_containers()
                          for b in c.list_blocks() for i in b.chunks)
            disp0 = sum(d._scrubber.dispatches for d in live)
            fused_kernel.launches.reset()
            t0 = time.perf_counter()
            found = {}
            for d in live:
                for _ in d.dn.list_containers():
                    errs = d.scan_once()
                    if errs:
                        found[d.dn.id] = errs
            scrub_s = time.perf_counter() - t0
            out["scrub_launches"] = fused_kernel.launches.count
            dispatches = sum(d._scrubber.dispatches for d in live) - disp0
            out["scrub_gib_s"] = scanned / scrub_s / 2**30
            print(f"daemon scrub: scan_once over the closed containers of {len(live)} "
                  f"daemons, {scanned} B in {scrub_s:.3f} s = {out['scrub_gib_s']:.3f} "
                  f"GiB/s (wall); kernel launches {out['scrub_launches']}, scrub "
                  f"dispatches {dispatches}")
            if found:
                raise AssertionError(f"the daemons' scrub found errors: {found}")
            if device.type == "cuda" and (out["scrub_launches"] <= 0
                                          or out["scrub_launches"] != dispatches):
                raise AssertionError("daemon scrub: launches differ from dispatches")
            out["degraded_gib_s"] = total / deg_s / 2**30
        finally:
            om.close()
            om_rpc.close()
            scm.close()
            clients.close()
            rpc_clients.close()
            for d in dns:
                d.stop()
            meta.stop()
    return out


#: keys of the CLI cluster's `freon ockg` and `freon s3kg` (a depth cut:
#: 16 in the cell)
OCKG_KEYS = 8


def daemon_cluster_processes(device, cell: int, seed: int) -> dict:
    """`python -m ozone_tpu_torch.tools cluster --datanodes 10` (the supervisor,
    an scm-om and ten datanode processes) driven through the CLI: a volume,
    an rs-6-3 bucket, a key put and get with a byte compare, freon ockg and
    admin status; then every process is torn down by pid."""
    import signal
    import socket

    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    dev = "cpu" if device.type == "cpu" else "cuda"
    rs = f"rs-6-3-{cell // 1024}k"
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    om = f"127.0.0.1:{port}"

    def cli(*argv, timeout=180):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ozone_tpu_torch.tools", *argv],
                              capture_output=True, text=True, timeout=timeout,
                              cwd=str(repo), env=env)
        if proc.returncode != 0:
            raise AssertionError(f"cli {argv[:3]} exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        return proc.stdout, time.perf_counter() - t0

    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        with open(root / "supervisor.log", "w") as log:
            sup = subprocess.Popen(
                [sys.executable, "-m", "ozone_tpu_torch.tools", "cluster",
                 "--datanodes", "10", "--port", str(port), "--root", str(root / "c"),
                 "--device", dev],
                stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                cwd=str(repo), env=env)
        pids: list[int] = []
        try:
            def up():
                text = (root / "supervisor.log").read_text()
                if sup.poll() is not None:
                    raise AssertionError(f"the cluster supervisor exited: {text[-2000:]}")
                for line in text.splitlines():
                    if line.startswith("cluster up:"):
                        pids[:] = json.loads(line.split("pids=")[1])
                        return True
                return False

            up_s = wait_for("the CLI cluster up", up, 180, poll_s=0.25)
            print(f"cli cluster: supervisor {sup.pid}, children {pids}, up in {up_s:.2f} s")
            rng = np.random.default_rng(seed + 8)
            payload = rng.integers(0, 256, 64 * cell + 12345, dtype=np.uint8)
            src, dst = root / "in.bin", root / "out.bin"
            src.write_bytes(payload.tobytes())
            times: dict[str, float] = {}

            def key_chain():
                """sh volume and bucket create, key put, key get."""
                for name, argv in (
                        ("volume create", ("sh", "volume", "create", "/cv", "--om", om)),
                        ("bucket create", ("sh", "bucket", "create", "/cv/b", "--om", om,
                                           "--replication", rs)),
                        ("key put", ("sh", "key", "put", "/cv/b/key", str(src), "--om", om,
                                     "--device", dev)),
                        ("key get", ("sh", "key", "get", "/cv/b/key", str(dst), "--om", om,
                                     "--device", dev))):
                    times[name] = cli(*argv)[1]
                return dst.read_bytes() == payload.tobytes()

            def ockg():
                text, times["freon ockg"] = cli(
                    "freon", "ockg", "-n", str(OCKG_KEYS), "-s", str(16 * cell), "--om", om,
                    "--device", dev, "--replication", rs)
                return json.loads(text)

            def status():
                text, times["admin status"] = cli("admin", "status", "--om", om)
                return json.loads(text)

            def s3_chain():
                return s3g_process(cli, root, om, rs, dev, cell, payload.tobytes(), times)

            t1 = time.perf_counter()
            same, rep, st, s3g = concurrent(lambda f: f(), [key_chain, ockg, status, s3_chain])
            print(f"cli commands, the key chain beside freon and admin status: "
                  f"{time.perf_counter() - t1:.2f} s; per process (interpreter start, "
                  f"torch, CUDA and all): " + ", ".join(f"{k} {v:.2f} s"
                                                        for k, v in times.items()))
            if not same:
                raise AssertionError("cli key get differs from the file put")
            print(f"cli sh key put / get of {payload.size} B: byte-exact")
            print(f"cli freon ockg -n {OCKG_KEYS} -s {16 * cell} (beside the key chain): ops "
                  f"{rep['ops']}, failures {rep['failures']}, {rep['throughput_mib_s']} "
                  f"MiB/s, p50 {rep['p50_ms']} ms in the freon process")
            if rep["ops"] != OCKG_KEYS or rep["failures"] != 0:
                raise AssertionError(f"cli freon ockg: {rep}")
            states = [n["state"] for n in st["nodes"]]
            print(f"cli admin status: {len(states)} datanodes {sorted(set(states))}, "
                  f"safemode {st['safemode']}, {st['containers']} containers")
            if states != ["HEALTHY"] * 10:
                raise AssertionError(f"cli admin status: {states}")
            devices, native = [], []
            for i in range(10):
                line = next(l for l in (root / "c" / f"dn{i}.log").read_text().splitlines()
                            if l.startswith(f"datanode dn{i} serving"))
                devices.append(line.rsplit("device=", 1)[1])
                native.append(line.split("native datapath=", 1)[1].split(",", 1)[0])
            print(f"cli datanode logs: devices {devices}; native datapath {native}")
            if devices != [str(torch.device(dev))] * 10:
                raise AssertionError(f"datanode devices {devices}")
            if not all(n.split(" ")[0].isdigit() for n in native):
                raise AssertionError(f"a datanode advertises no native datapath: {native}")
            out.update(ockg_mib_s=rep["throughput_mib_s"], s3g=s3g, **times)
        finally:
            if sup.poll() is None:
                sup.send_signal(signal.SIGTERM)
            try:
                sup.wait(timeout=30)
            except subprocess.TimeoutExpired:
                sup.kill()
                sup.wait()
            alive = []
            for pid in pids:
                try:
                    os.kill(pid, 0)
                    alive.append(pid)
                except ProcessLookupError:
                    pass
            for pid in alive:
                os.kill(pid, signal.SIGKILL)
            print(f"cli cluster torn down in {time.perf_counter() - t0:.2f} s of phase "
                  f"time; children still alive after the supervisor's teardown: {alive}")
            if alive:
                raise AssertionError(f"processes left behind: {alive}")
        # every chunk of the key chain and of freon rode the native lane
        lanes: dict[str, int] = {}
        for i in range(10):
            line = next(l for l in (root / "c" / f"dn{i}.log").read_text().splitlines()
                        if l.startswith(f"datanode dn{i} stopped"))
            for k, v in json.loads(line.split("by lane: ", 1)[1]).items():
                lanes[k] = lanes.get(k, 0) + v
        print(f"cli datanodes' chunk traffic by lane, summed: {lanes}")
        if lanes["native_write_streams"] <= 0 or lanes["native_read_streams"] <= 0 \
                or lanes["rpc_chunk_calls"]:
            raise AssertionError(f"cli cluster: chunks left the native lane: {lanes}")
        out["lanes"] = lanes
    return out


def s3g_process(cli, root: Path, om: str, rs: str, dev: str, cell: int, payload: bytes,
                times: dict) -> dict:
    """`python -m ozone_tpu_torch.tools s3g --require-auth` in front of the CLI
    cluster: `s3 getsecret`, one signed PUT and GET of `payload` byte-exact
    with its MD5 ETag, a 3-part multipart upload, `freon s3kg -n 8` signed
    with the secret; stopped, the gateway prints its kernel launches and
    codec-service dispatches, which must be equal."""
    import re
    import signal
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    repo = Path(__file__).resolve().parent
    log_path = root / "s3g.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        gw = subprocess.Popen(
            [sys.executable, "-m", "ozone_tpu_torch.tools", "s3g", "--om", om, "--port",
             str(port), "--replication", rs, "--device", dev, "--require-auth"],
            stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL, cwd=str(repo),
            env=dict(os.environ, PYTHONPATH=str(repo)))
    out: dict = {}
    try:
        def serving():
            if gw.poll() is not None:
                raise AssertionError(f"s3g exited: {log_path.read_text()[-2000:]}")
            return "s3 gateway serving" in log_path.read_text()

        times["s3g up"] = wait_for("s3g serving", serving, 180, poll_s=0.25)
        text, times["s3 getsecret"] = cli("s3", "getsecret", "smoke", "--om", om)
        s3 = S3Client(f"127.0.0.1:{port}", "smoke", json.loads(text)["secret"])
        s3.ok("PUT", "/cs3")
        t1 = time.perf_counter()
        h, _ = s3.ok("PUT", "/cs3/obj", payload)
        times["s3g PUT"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        back = s3.ok("GET", "/cs3/obj")[1]
        times["s3g GET"] = time.perf_counter() - t1
        if back != payload or h["etag"].strip('"') != hashlib.md5(payload).hexdigest():
            raise AssertionError("s3g PUT/GET differs")
        part = -(-len(payload) // 3)
        t1 = time.perf_counter()
        etag, parts = s3_multipart(s3, "/cs3/mp", payload, part, 3)
        times["s3g multipart"] = time.perf_counter() - t1
        if len(parts) != 3 or s3.ok("GET", "/cs3/mp")[1] != payload or not etag.endswith("-3"):
            raise AssertionError(f"s3g multipart: {etag} {len(parts)} parts")
        text, times["freon s3kg"] = cli("freon", "s3kg", "-n", str(OCKG_KEYS), "-s", str(cell),
                                        "--endpoint", f"127.0.0.1:{port}", "--access-id",
                                        "smoke", "--validate", "--om", om)
        out["s3kg"] = json.loads(text)
        if out["s3kg"]["ops"] != OCKG_KEYS or out["s3kg"]["failures"]:
            raise AssertionError(f"freon s3kg: {out['s3kg']}")
    finally:
        gw.send_signal(signal.SIGTERM)
        try:
            gw.wait(timeout=60)
        except subprocess.TimeoutExpired:
            gw.kill()
            gw.wait()
    last = log_path.read_text().strip().splitlines()[-1]
    m = re.match(r"s3 gateway stopped; kernel launches (\d+), service dispatches (\d+)$", last)
    if not m:
        raise AssertionError(f"s3g did not report its counts: {last!r}")
    out["launches"], out["dispatches"] = int(m.group(1)), int(m.group(2))
    print(f"cli s3g (--require-auth, {rs}, device {dev}): up in {times['s3g up']:.2f} s; "
          f"signed PUT / GET of {len(payload)} B byte-exact, ETag = MD5 "
          f"({times['s3g PUT']:.3f} / {times['s3g GET']:.3f} s); 3-part multipart upload "
          f"byte-exact, ETag {etag} ({times['s3g multipart']:.3f} s); freon s3kg -n {OCKG_KEYS} -s "
          f"{cell} --validate: {out['s3kg']['throughput_mib_s']} MiB/s, p50 "
          f"{out['s3kg']['p50_ms']} ms; stopped after {time.perf_counter() - t0:.2f} s: "
          f"kernel launches {out['launches']}, service dispatches {out['dispatches']}")
    if dev == "cuda" and (out["launches"] <= 0 or out["launches"] != out["dispatches"]):
        raise AssertionError(f"s3g: {out['launches']} launches for {out['dispatches']} "
                             f"service dispatches")
    return out


def daemon_path(device, cell: int, bpc: int, seed: int,
                in_process_put_gib_s: float = float("nan")) -> dict:
    """The port as a cluster of daemons: in process on loopback, then as
    processes through the CLI. Every library is built before anything is
    spawned, so the datanode processes load them instead of compiling."""
    from ozone_tpu_torch import cuda_build

    if device.type == "cuda":
        cuda_build.build_all()
    out = daemon_cluster_in_process(device, cell, bpc, seed, in_process_put_gib_s)
    out["cli"] = daemon_cluster_processes(device, cell, seed)
    return out


# ------------------------------------------------------------------ S3 path
class S3Client:
    """A SigV4 S3 client over keep-alive HTTP (one connection per
    thread), with the port's signers: the payload hash is signed, as the
    AWS CLI does over plain HTTP. `sign_s` sums the seconds spent signing
    (hashing the bodies), so the gateway's own time can be split off."""

    def __init__(self, endpoint: str, access_id: str, secret: str):
        self.endpoint, self.access_id, self.secret = endpoint, access_id, secret
        self._local = threading.local()
        self._lock = threading.Lock()
        self.sign_s = 0.0

    def _conn(self):
        import http.client

        c = getattr(self._local, "conn", None)
        if c is None:
            c = self._local.conn = http.client.HTTPConnection(self.endpoint, timeout=600)
        return c

    def url(self, path: str) -> str:
        return f"http://{self.endpoint}{path}"

    def headers(self, method: str, path: str, body=b"", extra=None, sign=True,
                streaming=False, secret=None) -> tuple[dict, bytes]:
        from ozone_tpu_torch.gateway.s3_auth import request_headers

        t0 = time.perf_counter()
        hdrs, body = request_headers(self.endpoint, method, path, body, extra,
                                     self.access_id if sign or streaming else None,
                                     secret or self.secret, streaming)
        with self._lock:
            self.sign_s += time.perf_counter() - t0
        return hdrs, body

    def send(self, method: str, path: str, body=b"", hdrs=None) -> tuple[int, dict, bytes]:
        c = self._conn()
        c.request(method, path, body=body, headers=hdrs or {})
        r = c.getresponse()
        data = r.read()
        if r.getheader("Connection", "").lower() == "close":
            c.close()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, data

    def req(self, method: str, path: str, body=b"", extra=None, **kw) -> tuple[int, dict, bytes]:
        hdrs, body = self.headers(method, path, body, extra, **kw)
        return self.send(method, path, body, hdrs)

    def ok(self, method: str, path: str, body=b"", extra=None, status=200, **kw):
        st, h, data = self.req(method, path, body, extra, **kw)
        if st != status:
            raise AssertionError(f"S3 {method} {path}: {st} {data[:300]!r}")
        return h, data


def xml_text(data: bytes, tag: str) -> list[str]:
    """The texts of every element `tag` of an S3 XML answer."""
    import xml.etree.ElementTree as ET

    return [el.text or "" for el in ET.fromstring(data).iter()
            if el.tag.rpartition("}")[2] == tag]


def s3_multipart(s3: S3Client, path: str, data, part: int, in_flight: int) -> tuple[str, list]:
    """One multipart upload of `data` in parts of `part` bytes, `in_flight`
    parts at once; ListParts and ListMultipartUploads are checked before
    the complete. Returns (the complete's ETag, the parts' ETags)."""
    from concurrent.futures import ThreadPoolExecutor

    _, body = s3.ok("POST", f"{path}?uploads")
    uid = xml_text(body, "UploadId")[0]
    chunks = [memoryview(data)[o:o + part] for o in range(0, len(data), part)]

    def put(i):
        h, _ = s3.ok("PUT", f"{path}?partNumber={i + 1}&uploadId={uid}", chunks[i])
        return h["etag"].strip('"')

    with ThreadPoolExecutor(in_flight) as pool:
        etags = list(pool.map(put, range(len(chunks))))
    _, listed = s3.ok("GET", f"{path}?uploadId={uid}")
    if xml_text(listed, "PartNumber") != [str(i + 1) for i in range(len(chunks))] or \
            [e.strip('"') for e in xml_text(listed, "ETag")] != etags:
        raise AssertionError(f"ListParts of {path}: {listed[:500]!r}")
    bucket, key = path.lstrip("/").split("/", 1)
    _, uploads = s3.ok("GET", f"/{bucket}?uploads&prefix={key}")
    if uid not in xml_text(uploads, "UploadId"):
        raise AssertionError(f"ListMultipartUploads misses {uid}")
    complete = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i + 1}</PartNumber><ETag>\"{e}\"</ETag></Part>"
        for i, e in enumerate(etags)) + "</CompleteMultipartUpload>").encode()
    _, done = s3.ok("POST", f"{path}?uploadId={uid}", complete)
    return xml_text(done, "ETag")[0].strip('"'), etags


def s3_path(device, cell: int, bpc: int, seed: int, n_clients: int = 4) -> dict:
    """The S3 gateway in this process (require_auth) in front of an
    OzoneClient on `device` over an ScmOmDaemon (through RemoteOmClient)
    and 12 DatanodeDaemons on the native lane; the bucket rs-6-3.
    `n_clients` concurrent clients each PUT a 64-cell object (payload hash signed)
    and upload a 96-cell + 12 345 B object in 8-cell parts, four parts in
    flight; GETs whole, ranged across part boundaries and by suffix; HEAD;
    ListObjectsV2 with a delimiter and paging; an aws-chunked PUT and a
    presigned GET; the refusals of unsigned and badly signed requests;
    the same PUTs and GETs through the OzoneClient alone; then two holders
    of the multipart objects' data units stopped, one object read untimed,
    and the objects read whole (degraded), through the gateway and the
    client. Every rate is
    printed beside the client's of the same bytes. Every body is byte-exact, every ETag the body's
    MD5 or the multipart composite, kernel launches equal the codec
    service's dispatches, and the native lane sees no fallback and no RPC
    chunk call."""
    from concurrent.futures import ThreadPoolExecutor

    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.gateway.s3 import S3Gateway
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.net.scm_service import RemoteScmClient
    from ozone_tpu_torch.om.multipart import _final_etag
    from ozone_tpu_torch.tools import cli

    rs = f"rs-6-3-{cell // 1024}k"
    part, in_flight = 8 * cell, 4
    rng = np.random.default_rng(seed + 10)
    singles = [rng.integers(0, 256, 64 * cell, dtype=np.uint8).tobytes()
               for _ in range(n_clients)]
    multis = [rng.integers(0, 256, 96 * cell + 12345, dtype=np.uint8).tobytes()
              for _ in range(n_clients)]
    put_bytes = sum(map(len, singles)) + sum(map(len, multis))
    out: dict = {}

    def md5(b) -> str:
        return hashlib.md5(b).hexdigest()

    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-s3-") as tmp:
        root = Path(tmp)
        meta = ScmOmDaemon(root / "om.db", block_size=16 * cell, container_size=256 * cell,
                           stale_after_s=30.0, dead_after_s=60.0, background_interval_s=0.5,
                           placement_seed=seed)
        meta.start()
        dns, gw = [], None
        clients = DatanodeClientFactory()
        om = RemoteOmClient(meta.address, clients=clients)
        scm = RemoteScmClient(meta.address)
        try:
            for i in range(12):
                d = DatanodeDaemon(root / f"dn{i}", f"dn{i}", meta.address, rack=f"/rack{i % 3}",
                                   heartbeat_interval_s=0.5, device=device)
                d.start()
                dns.append(d)
            by_id = {d.dn.id: d for d in dns}
            wait_for("12 datanodes registered", lambda: len(scm.status()["nodes"]) == 12, 30)
            oz = OzoneClient(om, clients, device=device)
            gw = S3Gateway(oz, replication=rs, require_auth=True)
            gw.start()
            # the secret the way a user gets it: `s3 getsecret` (in process)
            import io

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if cli.main(["s3", "getsecret", "chip", "--om", meta.address]) != 0:
                    raise AssertionError("s3 getsecret failed")
            secret = json.loads(buf.getvalue())["secret"]
            s3 = S3Client(gw.address, "chip", secret)
            s3.ok("PUT", "/s3b")
            print(f"s3 gateway: {gw.address} (require_auth) over RemoteOmClient -> ScmOmDaemon "
                  f"and 12 DatanodeDaemons, bucket {rs}, device {oz.device}")

            # 1. four clients: a signed single PUT each, then a multipart upload
            #    each, the gateway's launches equal to the service's dispatches
            def timed(what: str, fn, items, meter_dns=None) -> tuple[list, float, int]:
                before = service_counts()
                fused_kernel.launches.reset()
                since, t0 = time.time(), time.perf_counter()
                with LaneMeter(meter_dns if meter_dns is not None else dns) as m:
                    res = concurrent(fn, items)
                secs = time.perf_counter() - t0
                launches = fused_kernel.launches.count
                svc = service_delta(before)
                print(f"{what} spans: {span_totals(since)}")
                print(f"{what}: {m.line('batched_write_chunks' if 'PUT' in what else 'batched_read_chunks')}")
                if m.d["rpc_chunk_calls"] or (meter_dns is None and m.d["native_fallbacks"]):
                    raise AssertionError(f"{what} left the native lane: {m.d}")
                check_launches_equal(what, device, launches, svc)
                key = what.lower().replace(" ", "_")
                out["launches"][key if key.startswith("s3") else f"s3_{key}"] = launches
                return res, secs, launches

            def part_md5s(data) -> list[str]:
                return [md5(data[o:o + part]) for o in range(0, len(data), part)]

            def gw_single(i):
                h, _ = s3.ok("PUT", f"/s3b/c{i}/single", singles[i], {"x-amz-meta-client": str(i)})
                if h["etag"].strip('"') != md5(singles[i]):
                    raise AssertionError(f"single PUT {i}: ETag {h['etag']}")

            def gw_multi(i):
                etag, parts = s3_multipart(s3, f"/s3b/c{i}/multi", multis[i], part, in_flight)
                want = part_md5s(multis[i])
                if parts != want or etag != _final_etag([{"etag": e} for e in want]):
                    raise AssertionError(f"multipart {i}: ETag {etag}")

            s3.sign_s, out["launches"] = 0.0, {}
            _, single_s, single_n = timed("s3 single PUT", gw_single, list(range(n_clients)))
            _, mp_s, multi_n = timed("s3 multipart PUT", gw_multi, list(range(n_clients)))
            single_b, multi_b = sum(map(len, singles)), sum(map(len, multis))
            rates = {"single_put": single_b / single_s / 2**30,
                     "multipart_put": multi_b / mp_s / 2**30,
                     "put": put_bytes / (single_s + mp_s) / 2**30}
            print(f"s3 PUT: {n_clients} clients, each a signed {len(singles[0])} B PUT "
                  f"({rates['single_put']:.3f} GiB/s), then a {len(multis[0])} B multipart "
                  f"upload in {part} B parts, {in_flight} in flight "
                  f"({rates['multipart_put']:.3f} GiB/s); {put_bytes} B in "
                  f"{single_s + mp_s:.3f} s = {rates['put']:.3f} GiB/s (wall; client signing "
                  f"{s3.sign_s:.3f} s summed over threads); every ETag the MD5 or the composite")
            if device.type == "cuda" and min(single_n, multi_n) <= 0:
                raise AssertionError("an s3 PUT launched no kernel")

            # 2. GETs: whole, ranged across part boundaries, suffix; HEAD; listings
            names = [f"/s3b/c{i}/{k}" for i in range(n_clients) for k in ("single", "multi")]
            want = {f"/s3b/c{i}/single": singles[i] for i in range(n_clients)}
            want.update({f"/s3b/c{i}/multi": multis[i] for i in range(n_clients)})

            def gw_get(n):
                if s3.ok("GET", n)[1] != want[n]:
                    raise AssertionError(f"s3 GET {n}: bytes differ")

            _, get_s, _ = timed("s3 GET whole", gw_get, names)
            rates["get"] = put_bytes / get_s / 2**30
            ranges = [(f"/s3b/c{i}/multi", j * part + part // 2 + 777 + i, part)
                      for i in range(n_clients) for j in range(10)]

            def gw_ranged(r):
                name, lo, n = r
                h, data = s3.ok("GET", name, extra={"Range": f"bytes={lo}-{lo + n - 1}"},
                                status=206)
                if data != want[name][lo:lo + n] or \
                        h["content-range"] != f"bytes {lo}-{lo + n - 1}/{len(want[name])}":
                    raise AssertionError(f"ranged GET {name} {lo}+{n}")

            _, rng_s, _ = timed("s3 GET ranged", gw_ranged, ranges)
            ranged_b = part * len(ranges)
            rates["ranged_get"] = ranged_b / rng_s / 2**30
            h, tail = s3.ok("GET", "/s3b/c0/multi", extra={"Range": "bytes=-1000000"},
                            status=206)
            if tail != multis[0][-1000000:]:
                raise AssertionError("suffix GET differs")
            print(f"s3 GET whole: {put_bytes} B byte-exact in {get_s:.3f} s = "
                  f"{rates['get']:.3f} GiB/s; ranged: {len(ranges)} GETs of {part} B at odd "
                  f"offsets across part boundaries, {ranged_b} B byte-exact in {rng_s:.3f} s = "
                  f"{rates['ranged_get']:.3f} GiB/s; suffix bytes=-1000000 byte-exact")
            last = n_clients - 1
            st, h, _ = s3.req("HEAD", f"/s3b/c{last}/single")
            if st != 200 or int(h["content-length"]) != len(singles[last]) or \
                    h.get("x-amz-meta-client") != str(last):
                raise AssertionError(f"HEAD: {st} {h}")
            _, top = s3.ok("GET", "/s3b?list-type=2&delimiter=/")
            prefixes = xml_text(top, "Prefix")[1:]
            listed, token = [], ""
            while True:
                q = f"/s3b?list-type=2&prefix=c{last}/&delimiter=/&max-keys=1"
                _, page = s3.ok("GET", q + (f"&continuation-token={token}" if token else ""))
                listed += xml_text(page, "Key")
                token = (xml_text(page, "NextContinuationToken") or [""])[0]
                if not token:
                    break
            if prefixes != [f"c{i}/" for i in range(n_clients)] or \
                    listed != [f"c{last}/multi", f"c{last}/single"]:
                raise AssertionError(f"ListObjectsV2: {prefixes} {listed}")
            print(f"s3 HEAD (size, metadata) and ListObjectsV2 (delimiter: {prefixes}; "
                  f"max-keys=1 paging: {listed}): right")

            # 3. aws-chunked PUT of 16 cells, presigned GET of it
            from ozone_tpu_torch.gateway.s3_auth import presign_url

            chunked = rng.integers(0, 256, 16 * cell, dtype=np.uint8).tobytes()
            t0 = time.perf_counter()
            h, _ = s3.ok("PUT", "/s3b/chunked", chunked, streaming=True)
            ch_s = time.perf_counter() - t0
            url = presign_url("chip", secret, "GET", s3.url("/s3b/chunked"), 300)
            _, back = s3.ok("GET", url.split(gw.address, 1)[1], sign=False)
            if back != chunked or h["etag"].strip('"') != md5(chunked):
                raise AssertionError("aws-chunked PUT / presigned GET differ")
            print(f"s3 aws-chunked PUT of {len(chunked)} B (64 KiB chunks, one HMAC each) in "
                  f"{ch_s:.3f} s, presigned GET byte-exact, ETag = MD5")

            # 4. refusals
            st, _, err = s3.req("PUT", "/s3b/anon", b"x" * 1000, sign=False)
            st2, _, err2 = s3.req("PUT", "/s3b/forged", b"y" * 1000, secret="0" * 64)
            if (st, xml_text(err, "Code"), st2, xml_text(err2, "Code")) != \
                    (403, ["AccessDenied"], 403, ["SignatureDoesNotMatch"]):
                raise AssertionError(f"refusals: {st} {err[:200]!r} {st2} {err2[:200]!r}")
            print("s3 refusals: unsigned PUT 403 AccessDenied, bad signature 403 "
                  "SignatureDoesNotMatch")

            # 5. the same bytes through the OzoneClient alone: PUTs into a
            #    bucket of their own, GETs of the objects the gateway wrote
            direct = oz.get_volume("s3v").create_bucket("direct", replication=rs)
            s3b = oz.get_volume("s3v").get_bucket("s3b")

            def oz_multi(i):
                up = direct.initiate_multipart_upload(f"c{i}/multi")
                chunks = [memoryview(multis[i])[o:o + part] for o in range(0, len(multis[i]), part)]
                with ThreadPoolExecutor(in_flight) as pool:
                    list(pool.map(lambda j: up.write_part(j + 1, chunks[j]), range(len(chunks))))
                up.complete()

            def oz_get(n):
                if s3b.read_key(n[len("/s3b/"):]).tobytes() != want[n]:
                    raise AssertionError(f"OzoneClient GET {n}: bytes differ")

            def oz_ranged(r):
                name, lo, n = r
                if s3b.read_key_range(name[len("/s3b/"):], lo, n).tobytes() != \
                        want[name][lo:lo + n]:
                    raise AssertionError(f"OzoneClient ranged GET {name}")

            _, s, _ = timed("OzoneClient single PUT",
                            lambda i: direct.write_key(f"c{i}/single", singles[i]),
                            list(range(n_clients)))
            client = {"single_put": single_b / s / 2**30}
            _, s2, _ = timed("OzoneClient multipart PUT", oz_multi, list(range(n_clients)))
            client["multipart_put"] = multi_b / s2 / 2**30
            client["put"] = put_bytes / (s + s2) / 2**30
            _, s, _ = timed("OzoneClient GET whole", oz_get, names)
            client["get"] = put_bytes / s / 2**30
            _, s, _ = timed("OzoneClient GET ranged", oz_ranged, ranges)
            client["ranged_get"] = ranged_b / s / 2**30

            # 6. two holders of the multipart objects' data units stop: degraded GET
            info = om.lookup_key("s3v", "s3b", "c0/multi")
            down = info["block_groups"][0]["nodes"][:2]
            for dn_id in down:
                stop_server(by_id[dn_id])
            live = [d for d in dns if d.dn.id not in down]
            multi_names = [f"/s3b/c{i}/multi" for i in range(n_clients)]
            # one untimed read first: the first reader after the stop would
            # pay alone for finding the dead nodes (the gateway and the
            # OzoneClient below share one client and its health registry)
            oz_get(multi_names[0])
            _, deg_s, gw_n = timed("s3 degraded GET", gw_get, multi_names, live)
            rates["degraded_get"] = multi_b / deg_s / 2**30
            _, s, client_n = timed("OzoneClient degraded GET", oz_get, multi_names, live)
            client["degraded_get"] = multi_b / s / 2**30
            if device.type == "cuda" and min(gw_n, client_n) <= 0:
                raise AssertionError("a degraded GET launched no decode")
            print(f"s3 degraded GET ({down} stopped: data units 0 and 1 of c0/multi's first "
                  f"group): {multi_b} B of the multipart objects byte-exact in {deg_s:.3f} s")
            for k in ("single_put", "multipart_put", "put", "get", "ranged_get",
                      "degraded_get"):
                print(f"s3 rate {k}: {rates[k]:.3f} GiB/s through the gateway, "
                      f"{client[k]:.3f} GiB/s through the OzoneClient alone "
                      f"({rates[k] / client[k]:.2f}x; wall, this run)")
            out["gib_s"], out["client_gib_s"] = rates, client
        finally:
            if gw is not None:
                gw.stop()
            om.close()
            scm.close()
            clients.close()
            for d in dns:
                d.stop()
            meta.stop()
    return out


# ---------------------------------------------- lifecycle and small objects
def check_ec_units(dn_of, groups, data: np.ndarray, bpc: int, what: str,
                   crc_route: str = "numpy") -> int:
    """Every chunk of every unit of EC `groups` holding `data`: data chunks
    equal the source bytes, parity chunks equal the numpy coder's, and
    each chunk's stored CRC words equal the host CRC32C (numpy route, or
    the native library's with crc_route="native") of its bytes; every
    unit holds all its bytes. Returns the chunks held."""
    from ozone_tpu_torch.codec.numpy_coder import NumpyRSEncoder
    from ozone_tpu_torch.storage.ids import StorageError
    from ozone_tpu_torch.utils import checksum

    opts = groups[0].pipeline.replication.ec
    k, p, cell = opts.data_units, opts.parity_units, opts.cell_size
    enc = NumpyRSEncoder(opts)
    chunks, base = 0, 0
    with (checksum.numpy_route() if crc_route == "numpy"
          else contextlib.nullcontext()):
        for g in groups:
            n = -(-g.length // (k * cell))
            stripes = np.zeros((n, k, cell), dtype=np.uint8)
            stripes.reshape(-1)[:g.length] = data[base:base + g.length]
            base += g.length
            parity = enc.encode(stripes)
            held = 0
            for u, dn_id in enumerate(g.pipeline.nodes):
                try:
                    block = dn_of(dn_id).get_block(g.block_id)
                except StorageError:  # a unit the group's data never reached
                    block = None
                infos = block.chunks if block else []
                for ch in infos:
                    s = ch.offset // cell
                    want = (stripes[s, u] if u < k else parity[s, u - k])[:ch.length]
                    got = dn_of(dn_id).read_chunk(g.block_id, ch)
                    if not np.array_equal(got, want):
                        raise AssertionError(f"{what}: chunk {ch.name} unit {u} differs "
                                             "from the numpy coder's")
                    words = [int.from_bytes(c, "big") for c in ch.checksum.checksums]
                    if words != checksum.crc32c_slices(got, bpc).tolist():
                        raise AssertionError(f"{what}: stored CRCs of {ch.name} unit {u} "
                                             "differ from the host CRC32C")
                    held += ch.length if u < k else 0
                    chunks += 1
                if u >= k and len(infos) != n:
                    raise AssertionError(f"{what}: parity unit {u} holds {len(infos)} "
                                         f"of {n} chunks")
            if held != g.length:
                raise AssertionError(f"{what}: data units hold {held} of {g.length} B")
    if base != data.size:
        raise AssertionError(f"{what}: groups cover {base} of {data.size} B")
    return chunks


@contextlib.contextmanager
def daemon_cluster(device, n_dn: int, cell: int, seed: int, tag: str,
                   background_interval_s: float = 0.5, ratis: bool = False,
                   layouts: dict | None = None, meta_kw: dict | None = None):
    """An ScmOmDaemon (its lifecycle sweep on `device`, its background pass
    every `background_interval_s`, and `meta_kw` such as its HTTP and
    Recon ports) and `n_dn` DatanodeDaemons on loopback, each with its
    native datapath, and an OzoneClient over RemoteOmClient (with `ratis`,
    RATIS/THREE keys go through the pipeline rings); yields (meta,
    daemons, client). `layouts` seeds `layout_version.json` before the
    daemons start: key "meta" for the metadata services, an int i for
    datanode i."""
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.net.scm_service import RemoteScmClient

    old_period = os.environ.get("OZONE_TPU_LIFECYCLE_PERIOD_S")
    # no sweep of the daemon's own cadence: the phase drives them
    os.environ["OZONE_TPU_LIFECYCLE_PERIOD_S"] = "1e9"
    with tempfile.TemporaryDirectory(prefix=f"chip-smoke-{tag}-") as tmp:
        root = Path(tmp)
        for where, version in (layouts or {}).items():
            d = root if where == "meta" else root / f"dn{where}"
            d.mkdir(parents=True, exist_ok=True)
            (d / "layout_version.json").write_text(
                json.dumps({"layout_version": version}))
        try:
            meta = ScmOmDaemon(root / "om.db", block_size=16 * cell,
                               container_size=4096 * cell, stale_after_s=30.0,
                               dead_after_s=60.0,
                               background_interval_s=background_interval_s,
                               placement_seed=seed, device=device,
                               **(meta_kw or {}))
        finally:
            if old_period is None:
                os.environ.pop("OZONE_TPU_LIFECYCLE_PERIOD_S")
            else:
                os.environ["OZONE_TPU_LIFECYCLE_PERIOD_S"] = old_period
        meta.start()
        dns = []
        clients = DatanodeClientFactory()
        om = RemoteOmClient(meta.address, clients=clients)
        scm = RemoteScmClient(meta.address)
        try:
            for i in range(n_dn):
                d = DatanodeDaemon(root / f"dn{i}", f"dn{i}", meta.address,
                                   heartbeat_interval_s=0.5, device=device)
                d.start()
                dns.append(d)
            wait_for(f"{n_dn} datanodes registered",
                     lambda: len(scm.status()["nodes"]) == n_dn, 30)
            ratis_clients = None
            if ratis:
                from ozone_tpu_torch.net.ratis_service import RatisClientFactory

                for d in dns:
                    clients.register_remote(d.dn.id, d.address)
                ratis_clients = RatisClientFactory(
                    address_source=clients.remote_address)
            try:
                yield meta, dns, OzoneClient(om, clients, device=device,
                                             ratis_clients=ratis_clients)
            finally:
                if ratis_clients is not None:
                    ratis_clients.close()
        finally:
            scm.close()
            om.close()
            clients.close()
            for d in dns:
                d.stop()
            meta.stop()


#: the metadata verbs whose count per operation sets the small-object and
#: tiering rates (each a client span of the port's RPC)
METADATA_RPCS = ("DatanodeService/CreateContainer", "DatanodeService/GetBlock",
                 "OmService/AllocateSlabGroup", "OmService/AllocateBlock",
                 "OmService/CommitKeys", "OmService/CommitKey",
                 "OmService/PutInlineKey", "OmService/LookupKey")


def rpc_counts(since: float) -> str:
    """Client RPCs of METADATA_RPCS since `since`: count and seconds summed
    over threads."""
    out = []
    for verb in METADATA_RPCS:
        n, secs = span_stat(since, f"client:/ozone.tpu.{verb}")
        if n:
            out.append(f"{verb.split('/')[1]} {n} x {secs:.2f} s")
    return ", ".join(out) or "none"


def cli_json(*argv) -> object:
    """The port's CLI in this process; its printed JSON answer."""
    import io

    from ozone_tpu_torch.tools import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    if rc != 0:
        raise AssertionError(f"CLI {' '.join(argv)} exited {rc}")
    return json.loads(buf.getvalue())


def lifecycle_path(device, cell: int, bpc: int, seed: int, big_keys: int = 16,
                   big_cells: int = 16, short_keys: int = 8, xor_keys: int = 4,
                   xor_cells: int = 12, window: int = 16) -> dict:
    """Lifecycle tiering on the device. A MiniOzoneCluster of 9 datanodes
    (as bench.py's tiering bench) with OZONE_TPU_TIER_BATCH=`window`, a
    RATIS/THREE bucket: `big_keys` keys of `big_cells` cells, `short_keys`
    of a cell + 12 345 B (short groups) and `xor_keys` written as XOR(6,1)
    of `xor_cells` cells + 7 B. An age-0 TRANSITION_TO_EC rule to rs-6-3,
    swept by one LifecycleService.run_once on the codec service: the XOR
    keys (first in name order) through the fused re-encode, the rest
    packed into [window, 6, cell] windows. Every key re-reads byte-exact,
    and every unit's chunks, parity and stored CRCs equal the numpy
    coder's and the host CRC32C. Then an EXPIRE rule on half the short
    keys and a second sweep; the survivors re-read byte-exact. Last, on a
    daemon cluster of 9 DatanodeDaemons: the rule PUT through an
    S3Gateway's `?lifecycle` on a RATIS/THREE bucket, two keys PUT through
    the gateway, `lifecycle run-now` over the remote OM (the sweep runs in
    the ScmOmDaemon on `device`), and both keys GET through the gateway
    byte-exact and rs-6-3. Kernel launches equal the codec service's
    dispatches in each sweep, and the tiering sweep takes fewer
    dispatches than keys."""
    import http.client

    from ozone_tpu_torch.client import re_encode
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.gateway.s3 import S3Gateway
    from ozone_tpu_torch.lifecycle.service import LifecycleService
    from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

    rs, xor = f"rs-6-3-{cell // 1024}k", f"xor-6-1-{cell // 1024}k"
    rng = np.random.default_rng(seed + 20)
    sizes = {f"a-xor-{i}": xor_cells * cell + 7 for i in range(xor_keys)}
    sizes.update({f"cold-{i:02d}": big_cells * cell for i in range(big_keys)})
    sizes.update({f"short-{'ab'[i % 2]}{i // 2}": cell + 12345
                  for i in range(short_keys)})
    data = {k: rng.integers(0, 256, n, dtype=np.uint8) for k, n in sizes.items()}
    out: dict = {}
    old_batch = os.environ.get("OZONE_TPU_TIER_BATCH")
    os.environ["OZONE_TPU_TIER_BATCH"] = str(window)
    try:
        with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-lc-") as tmp:
            cluster = MiniOzoneCluster(Path(tmp), num_datanodes=9, block_size=32 * cell,
                                       container_size=1024 * cell, stale_after_s=1e6,
                                       dead_after_s=2e6, placement_seed=seed, device=device)
            try:
                oz = cluster.client()
                b = oz.create_volume("tier").create_bucket("b", replication="RATIS/THREE")
                for name, d in data.items():
                    b.write_key(name, d, xor if name.startswith("a-xor") else None)
                cluster.om.set_bucket_lifecycle("tier", "b", [{
                    "id": "warm", "prefix": "", "age_days": 0,
                    "action": "TRANSITION_TO_EC", "target": rs}])
                svc = LifecycleService(cluster.om, clients=cluster.clients, device=device)
                xor_launches = [0]
                real = re_encode.re_encode_xor_key_to_rs

                def counted(*a, **kw):  # the XOR keys' share of the launches
                    before = fused_kernel.launches.count
                    try:
                        return real(*a, **kw)
                    finally:
                        xor_launches[0] += fused_kernel.launches.count - before

                re_encode.re_encode_xor_key_to_rs = counted
                before = service_counts()
                fused_kernel.launches.reset()
                since, t0 = time.time(), time.perf_counter()
                try:
                    stats = svc.run_once()
                finally:
                    re_encode.re_encode_xor_key_to_rs = real
                secs = time.perf_counter() - t0
                launches = fused_kernel.launches.count
                svc_d = service_delta(before)
                stripes = sum(-(-n // (6 * cell)) for k, n in sizes.items()
                              if not k.startswith("a-xor"))
                print(f"lifecycle sweep spans: {span_totals(since)}")
                print(f"lifecycle sweep: {stats['transitioned']} of {len(sizes)} keys "
                      f"({big_keys} x {big_cells} cells, {short_keys} x 1 cell + 12345 B "
                      f"replicated; {xor_keys} x {xor} {xor_cells} cells + 7 B) -> {rs}, "
                      f"{stats['bytes']} B in {secs:.3f} s = "
                      f"{stats['bytes'] / secs / 2**30:.3f} GiB/s; tier dispatches "
                      f"{stats['dispatches']} for {stripes} replicated stripes at window "
                      f"{window}; kernel launches {launches} (XOR re-encode "
                      f"{xor_launches[0]}), service dispatches {svc_d['dispatches']} of "
                      f"{svc_d['submissions']} submissions, fill {svc_d['fill_ratio']:.3f}")
                if stats["transitioned"] != len(sizes) or stats["failed"] \
                        or stats["conflicts"] or not stats["complete"]:
                    raise AssertionError(f"lifecycle sweep: {stats}")
                if stats["dispatches"] != -(-stripes // window) \
                        or stats["dispatches"] >= len(sizes):
                    raise AssertionError(f"tier dispatches {stats['dispatches']} for "
                                         f"{stripes} stripes, {len(sizes)} keys")
                check_launches_equal("lifecycle sweep", device, launches, svc_d)
                out.update(tier_launches=launches - xor_launches[0],
                           xor_launches=xor_launches[0], gib_s=stats["bytes"] / secs / 2**30,
                           seconds=secs, dispatches=stats["dispatches"], stripes=stripes)
                if device.type == "cuda" and (xor_launches[0] < xor_keys
                                              or out["tier_launches"] != stats["dispatches"]):
                    raise AssertionError(f"lifecycle launches: {out}")
                chunks = groups = 0
                dn_of = cluster.datanode
                for name, want in data.items():
                    info = cluster.om.lookup_key("tier", "b", name)
                    groups += len(info["block_groups"])
                    if info["replication"] != rs:
                        raise AssertionError(f"{name} is {info['replication']}")
                    if not np.array_equal(b.read_key(name), want):
                        raise AssertionError(f"tiered {name} re-read differs")
                    chunks += check_ec_units(dn_of, cluster.om.key_block_groups(info),
                                             want, bpc, name)
                print(f"lifecycle: {len(data)} tiered keys re-read byte-exact; {chunks} "
                      "chunks' data, parity and CRC words equal the numpy coder's and the "
                      f"host CRC32C; the sweep wrote {groups} groups ({9 * groups} "
                      "CreateContainer calls, one per member of each)")
                # expiry of half the short keys
                cluster.om.set_bucket_lifecycle("tier", "b", [{
                    "id": "ttl", "prefix": "short-b", "age_days": 0,
                    "action": "EXPIRE"}])
                before = service_counts()
                fused_kernel.launches.reset()
                stats2 = svc.run_once()
                expired = [k for k in data if k.startswith("short-b")]
                if stats2["expired"] != len(expired) or fused_kernel.launches.count:
                    raise AssertionError(f"expiry sweep: {stats2}")
                for name, want in data.items():
                    if name in expired:
                        try:
                            cluster.om.lookup_key("tier", "b", name)
                        except Exception:  # noqa: BLE001 - KEY_NOT_FOUND
                            continue
                        raise AssertionError(f"expired {name} still listed")
                    if not np.array_equal(b.read_key(name), want):
                        raise AssertionError(f"survivor {name} re-read differs")
                print(f"lifecycle expiry: {stats2['expired']} keys expired, "
                      f"{len(data) - len(expired)} survivors re-read byte-exact")
            finally:
                cluster.close()

        # the same rule through the S3 gateway and `lifecycle run-now` over
        # the daemon cluster's remote OM
        with codec_route(True), daemon_cluster(device, 9, cell, seed, "lc") as (meta, _, oz):
            gw = S3Gateway(oz, replication="RATIS/THREE")
            gw.start()
            try:
                conn = http.client.HTTPConnection(gw.address, timeout=120)

                def req(method, path, body=b""):
                    conn.request(method, path, body=body)
                    r = conn.getresponse()
                    return r.status, r.read()

                rule = (f"<LifecycleConfiguration><Rule><ID>warm</ID><Filter><Prefix>"
                        f"</Prefix></Filter><Status>Enabled</Status><Transition><Days>0"
                        f"</Days><StorageClass>{rs}</StorageClass></Transition></Rule>"
                        f"</LifecycleConfiguration>").encode()
                bodies = {f"k{i}": rng.integers(0, 256, big_cells * cell + 7,
                                                dtype=np.uint8).tobytes() for i in range(2)}
                steps = [req("PUT", "/lcb"), req("PUT", "/lcb?lifecycle", rule)]
                steps += [req("PUT", f"/lcb/{k}", v) for k, v in bodies.items()]
                status, got = req("GET", "/lcb?lifecycle")
                if any(s[0] != 200 for s in steps) or status != 200 \
                        or rs.encode() not in got:
                    raise AssertionError(f"?lifecycle through the gateway: {steps} {status}")
                before = service_counts()
                fused_kernel.launches.reset()
                t0 = time.perf_counter()
                since = time.time()
                run = cli_json("lifecycle", "run-now", "--om", meta.address)
                secs = time.perf_counter() - t0
                print(f"lifecycle run-now metadata RPCs: {rpc_counts(since)}")
                launches = fused_kernel.launches.count
                svc_d = service_delta(before)
                if run["transitioned"] != 2 or run["failed"]:
                    raise AssertionError(f"lifecycle run-now: {run}")
                check_launches_equal("lifecycle run-now (daemon)", device, launches, svc_d)
                for k, v in bodies.items():
                    status, got = req("GET", f"/lcb/{k}")
                    if status != 200 or got != v:
                        raise AssertionError(f"gateway GET of tiered {k} differs")
                    info = oz.om.lookup_key("s3v", "lcb", k)
                    if info["replication"] != rs:
                        raise AssertionError(f"{k} is {info['replication']} after run-now")
                status = cli_json("lifecycle", "status", "--om", meta.address)
                print(f"lifecycle over the daemons: ?lifecycle PUT and GET through the "
                      f"gateway, 2 keys tiered by `lifecycle run-now` in {secs:.3f} s "
                      f"({run['bytes']} B, {run['dispatches']} dispatches; kernel launches "
                      f"{launches}, service dispatches {svc_d['dispatches']}), GET "
                      f"byte-exact; status term {status['term']}, cursor "
                      f"{status['cursor']}")
                out["daemon_launches"] = launches
                conn.close()
            finally:
                gw.stop()
    finally:
        if old_batch is None:
            os.environ.pop("OZONE_TPU_TIER_BATCH", None)
        else:
            os.environ["OZONE_TPU_TIER_BATCH"] = old_batch
    return out


def small_object_path(device, cell: int, bpc: int, seed: int, n_keys: int = 2000,
                      size: int = 64 * 1024, n_plain: int = 500, threads: int = 16,
                      compact_slabs: int = 32) -> dict:
    """The small-object path on a daemon cluster (ScmOmDaemon and 9
    DatanodeDaemons, native lane): an rs-6-3 bucket opted in by `sh bucket
    set-smallobj`; freon tinyg of `n_keys` keys of `size` B on `threads`
    threads (needles through the client's SlabPacker), then `n_keys` keys of
    the tiny mix (inline values and needles); `n_plain` keys of `size` B
    with packer=False (every key down the stripe path), the before/after
    pair. Every key reads back byte-exact; the first slab's units hold the
    numpy coder's parity and the host CRC32C words. Then every other needle
    of the first run is deleted, the purge books them dead on their slabs,
    one `compact_slabs_once` over the remote OM (dead ratio 0.4, at most
    `compact_slabs` slabs) rewrites their survivors, and every survivor
    reads back byte-exact. Kernel launches equal the codec service's
    dispatches in every step."""
    from concurrent.futures import ThreadPoolExecutor

    from ozone_tpu_torch.client import slab
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.tools import freon

    from collections import deque

    from ozone_tpu_torch.utils.tracing import Tracer

    rs = f"rs-6-3-{cell // 1024}k"
    out: dict = {"launches": {}}
    tracer = Tracer.instance()
    # room for every span of the phase: its RPC counts are read from them
    tracer.spans = deque(tracer.spans, maxlen=max(tracer.spans.maxlen, 500_000))
    with codec_route(True), daemon_cluster(device, 9, cell, seed, "so") as (meta, dns, oz):
        om = oz.om
        om.create_volume("so")
        for bucket in ("tiny", "mix", "plain"):
            om.create_bucket("so", bucket, rs)
        for bucket in ("tiny", "mix"):
            row = cli_json("sh", "bucket", "set-smallobj", f"/so/{bucket}",
                           "--om", meta.address)
            if row.get("smallobj") is None:
                raise AssertionError(f"set-smallobj: {row}")
        by_id = {d.dn.id: d.dn for d in dns}

        def step(what, fn):
            before, s0 = service_counts(), slab.METRICS.snapshot()
            fused_kernel.launches.reset()
            since, t0 = time.time(), time.perf_counter()
            res = fn()
            secs = time.perf_counter() - t0
            launches = fused_kernel.launches.count
            svc_d = service_delta(before)
            s1 = slab.METRICS.snapshot()
            d = {k: s1.get(k, 0) - s0.get(k, 0) for k in
                 ("slabs_flushed", "needles_packed", "slab_bytes", "inline_puts")}
            print(f"{what} metadata RPCs: {rpc_counts(since)}")
            check_launches_equal(what, device, launches, svc_d)
            return res, secs, launches, svc_d, d

        def readback(bucket, names, want):
            b = oz.get_volume("so").get_bucket(bucket)

            def one(i):
                if not np.array_equal(b.read_key(names[i]), want(i)):
                    raise AssertionError(f"{bucket}/{names[i]} read back differs")

            since = time.time()
            with ThreadPoolExecutor(threads) as ex:
                list(ex.map(one, range(len(names))))
            print(f"{bucket} read back, metadata RPCs: {rpc_counts(since)}")

        reps = {}
        for what, bucket, n, kw in (
                ("tinyg needles", "tiny", n_keys, dict(size=size)),
                ("tinyg mix", "mix", n_keys, dict(size=size, mix=True)),
                ("tinyg packer=False", "plain", n_plain, dict(size=size, packer=False))):
            rep, secs, launches, svc_d, d = step(what, lambda: freon.tinyg(
                oz, n_keys=n, threads=threads, volume="so", bucket=bucket,
                replication=rs, validate=False, **kw).summary())
            if rep["failures"]:
                raise AssertionError(f"{what}: {rep['failures']} failures")
            names = [f"tiny-{i}" for i in range(n)]
            t0 = time.perf_counter()
            readback(bucket, names, lambda i, kw=kw: freon._det_payload(
                freon._tiny_size(i, size, kw.get("mix", False)), seed=i))
            read_s = time.perf_counter() - t0
            per_slab = d["needles_packed"] / d["slabs_flushed"] if d["slabs_flushed"] else 0
            fill = (100.0 * d["slab_bytes"] / (d["slabs_flushed"] * oz.packer.target_bytes)
                    if d["slabs_flushed"] else 0.0)
            print(f"small objects, {what}: {n} keys on {threads} threads in "
                  f"{rep['elapsed_s']} s, {rep['ops_per_s']} ops/s, p50 {rep['p50_ms']} ms, p99 "
                  f"{rep['p99_ms']} ms; inline {rep['inline_keys']}, needles "
                  f"{rep['needle_keys']}, stripe path {rep['regular_keys']}; slabs "
                  f"flushed {d['slabs_flushed']}, {per_slab:.1f} needles per slab, fill "
                  f"{fill:.1f}%; kernel launches {launches}, service dispatches "
                  f"{svc_d['dispatches']}; read back byte-exact in {read_s:.3f} s "
                  f"({n / read_s:.1f} GETs/s)")
            reps[bucket] = dict(rep, launches=launches, slabs=d["slabs_flushed"],
                                needles_per_slab=per_slab, fill_pct=fill, read_s=read_s)
        if (reps["tiny"]["needle_keys"], reps["plain"]["regular_keys"]) != (n_keys, n_plain):
            raise AssertionError(f"small-object routing: {reps}")
        out["launches"]["slab_flush"] = reps["tiny"]["launches"] + reps["mix"]["launches"]
        out["launches"]["small_object_stripe_path"] = reps["plain"]["launches"]
        out["reps"] = reps
        # the first slab: its units against the numpy coder and host CRCs
        first = min(om.list_slabs("so", "tiny"), key=lambda s: s["created"])
        payload = np.zeros(first["length"], np.uint8)
        for name, nd in first["needles"].items():
            i = int(name.rsplit("-", 1)[1])
            payload[nd["off"]:nd["off"] + nd["len"]] = freon._det_payload(size, seed=i)
        groups = om.key_block_groups({"block_groups": first["block_groups"]})
        chunks = check_ec_units(lambda dn_id: by_id[dn_id], groups, payload, bpc,
                                "slab " + first["slab_id"])
        print(f"small objects: slab {first['slab_id']} ({len(first['needles'])} needles, "
              f"{first['length']} B): {chunks} chunks' data, parity and CRC words equal "
              f"the numpy coder's and the host CRC32C")

        # delete every other needle, purge, compact, read the survivors
        b = oz.get_volume("so").get_bucket("tiny")
        with ThreadPoolExecutor(threads) as ex:
            list(ex.map(lambda i: b.delete_key(f"tiny-{i}"), range(0, n_keys, 2)))
        with meta.scm_service.lock:  # not beside the daemon's own pass
            while meta.om.run_key_deleting_service_once(limit=10_000):
                pass
        os.environ["OZONE_TPU_SLAB_DEAD_RATIO"] = "0.4"
        try:
            # at most `compact_slabs` slabs: the daemon's sweep budget
            # (OZONE_TPU_LIFECYCLE_DEADLINE_S, 30 s) bounds one call
            stats, secs, launches, svc_d, _ = step(
                "slab compaction",
                lambda: om.run_slab_compaction_once(max_slabs=compact_slabs))
        finally:
            os.environ.pop("OZONE_TPU_SLAB_DEAD_RATIO", None)
        survivors = [f"tiny-{i}" for i in range(1, n_keys, 2)]
        readback("tiny", survivors,
                 lambda i: freon._det_payload(size, seed=2 * i + 1))
        print(f"small objects, compaction: {stats['compacted']} of {stats['slabs_scanned']} "
              f"slabs compacted, {stats['needles_rewritten']} needles "
              f"({stats['bytes_rewritten']} B) rewritten in {secs:.3f} s "
              f"({stats['bytes_rewritten'] / secs / MIB:.1f} MiB/s), "
              f"{stats['blocks_released']} blocks released, conflicts "
              f"{stats['conflicts']}; kernel launches {launches}, service dispatches "
              f"{svc_d['dispatches']}; {len(survivors)} survivors read back byte-exact")
        if stats["compacted"] < 1 or stats["needles_rewritten"] < 1 or stats["conflicts"]:
            raise AssertionError(f"slab compaction: {stats}")
        out["launches"]["slab_compaction"] = launches
        out["compaction"] = dict(stats, seconds=secs)
    return out


def hist_window(hs: list, before: list) -> dict:
    """p50 and p99 (the histograms' own bucket interpolation) and count of
    the observations of metrics Histograms (one bucket layout) since their
    bucket counts `before`, pooled."""
    h = hs[0]
    counts = [sum(x._counts[i] - b[i] for x, b in zip(hs, before))
              for i in range(len(h._counts))]
    n = sum(counts)
    out = {"n": n}
    for name, q in (("p50", 0.50), ("p99", 0.99)):
        target, cum, v = q * n, 0, 0.0
        for i, c in enumerate(counts):
            if c and cum + c >= target:
                lo = h.bounds[i - 1] if i > 0 else 0.0
                hi = h.bounds[i] if i < len(h.bounds) else max(h.max, lo)
                v = lo + (hi - lo) * (target - cum) / c
                break
            cum += c
        out[name] = v
    return out


def elections(cluster) -> str:
    """Each metadata replica's role, term and election counters."""
    out = []
    for mid, d in sorted(cluster.metas.items()):
        n = d.ha.node
        c = {k: n.metrics.counter(k).value
             for k in ("elections_started", "elections_won", "step_downs")}
        out.append(f"{mid} {n.role} term {n.storage.term} elections started "
                   f"{c['elections_started']} won {c['elections_won']} step-downs "
                   f"{c['step_downs']}")
    return "; ".join(out)


def ha_path(device, cell: int, bpc: int, seed: int, n_ec: int = 8,
            ec_size: int = 64 * MIB, n_fail: int = 16, fail_size: int = 16 * MIB,
            n_ratis: int = 8, ratis_size: int = 16 * MIB, threads: int = 4) -> dict:
    """Consensus and HA: three ScmOmDaemons on one metadata ring over the
    port's RPC and 9 DatanodeDaemons on 3 racks (MiniOzoneHACluster; the
    daemon path's heartbeat timings, 16 MiB blocks, rs-6-3-1024k on
    `device`). (a) `n_ec` EC keys through the ring on `threads` threads:
    GiB/s, the leader's raft `commit_seconds` p50/p99, `om:submit` seconds,
    launches = dispatches, every chunk against the numpy coder's parity and
    the host CRC32C. (b) `n_fail` keys while the leader is stopped after the
    4th acknowledged key: failover seconds (stop to the first key the new
    leader committed and acknowledged; CommitKey answers are recorded by
    replica) beside the stop's own seconds, retried operations; every acknowledged key reads
    back byte-exact from the new leader; the old leader revived and caught
    up (seconds until its last_applied reaches the leader's); `admin
    ring-status` from every replica shows three members in sync. (c)
    `n_ratis` RATIS/THREE keys through the pipeline rings, one pipeline
    member stopped after the 2nd key: GiB/s and the raft round trips of
    `write_chunk_commit` and `put_block`; every key reads back byte-exact
    from the live members, which hold its committed length. (d) a degraded
    GET of (a)'s keys with two datanodes down, through the decode form."""
    from concurrent.futures import ThreadPoolExecutor

    from ozone_tpu_torch.client import ratis_client, resilience
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.net import rpc
    from ozone_tpu_torch.storage.ids import StorageError
    from ozone_tpu_torch.testing.minicluster import MiniOzoneHACluster

    import logging

    rs = f"rs-6-3-{cell // 1024}k"
    gib = float(1 << 30)
    rng = np.random.default_rng(seed)
    out: dict = {"launches": {}}
    # every election of the phase in the log ("leader of term N")
    logging.basicConfig(level=logging.WARNING)
    logging.getLogger("ozone_tpu_torch.consensus.raft").setLevel(logging.INFO)
    # the earlier phases' spans (up to 500 000) leave the tracer's buffer:
    # a full collection over them pauses every thread, the ring's
    # heartbeat timers too
    from ozone_tpu_torch.utils.tracing import Tracer

    Tracer.instance().spans.clear()
    gc.collect()
    old_period = os.environ.get("OZONE_TPU_LIFECYCLE_PERIOD_S")
    os.environ["OZONE_TPU_LIFECYCLE_PERIOD_S"] = "1e9"  # no sweeps of its own
    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-ha-") as tmp:
        try:
            cluster = MiniOzoneHACluster(
                Path(tmp), num_meta=3, num_datanodes=9, block_size=16 * cell,
                heartbeat_interval_s=0.5, device=device, racks=3,
                container_size=4096 * cell, stale_after_s=30.0, dead_after_s=60.0,
                background_interval_s=0.5, placement_seed=seed)
        finally:
            if old_period is None:
                os.environ.pop("OZONE_TPU_LIFECYCLE_PERIOD_S")
            else:
                os.environ["OZONE_TPU_LIFECYCLE_PERIOD_S"] = old_period
        try:
            wait_for("9 datanodes registered on the ring's leader",
                     lambda: len(cluster.metas[cluster.await_leader()].scm.nodes.nodes())
                     == 9, 30)
            oz = cluster.client()
            by_id = {d.dn.id: d for d in cluster.datanodes}

            def once(fn, *a):
                """A setup verb through the ring: a write retried across a
                leader change may find its first attempt committed."""
                try:
                    fn(*a)
                except StorageError as e:
                    if not e.code.endswith("_ALREADY_EXISTS"):
                        raise
                    print(f"ha: {fn.__name__}{a} found its first attempt committed")

            once(oz.om.create_volume, "ha")
            vol = oz.get_volume("ha")
            once(oz.om.create_bucket, "ha", "ec", rs)
            ec = vol.get_bucket("ec")
            # what one fsync'd append costs on this host's disk (the floor
            # under every raft commit)
            from ozone_tpu_torch.consensus.raft import RaftStorage

            probe = RaftStorage(Path(tmp) / "fsync-probe")
            t0 = time.perf_counter()
            for i in range(200):
                probe.append([{"term": 1, "data": {"i": i}}])
            fsync_ms = 1e3 * (time.perf_counter() - t0) / 200
            probe.close()
            print(f"ha: one fsync'd raft log append takes {fsync_ms:.3f} ms on this "
                  "host's disk (mean of 200)")
            out["fsync_append_ms"] = fsync_ms

            def put_all(bucket, names, datas, n_threads, on_ack=None):
                """write_key of every key; a key whose write raised is written
                again (at most 3 times). Returns (seconds, retried keys)."""
                retried = [0]

                def one(i):
                    for attempt in range(3):
                        try:
                            bucket.write_key(names[i], datas[i])
                            break
                        except Exception as e:
                            if attempt == 2:
                                raise
                            retried[0] += 1
                            print(f"ha: write of {names[i]} retried after {e!r}")
                    if on_ack is not None:
                        on_ack(i)

                t0 = time.perf_counter()
                with ThreadPoolExecutor(n_threads) as ex:
                    list(ex.map(one, range(len(names))))
                return time.perf_counter() - t0, retried[0]

            # ---- (a) EC keys through the ring
            names = [f"ec-{i}" for i in range(n_ec)]
            datas = [np.frombuffer(rng.bytes(ec_size), np.uint8) for _ in names]
            leader = cluster.await_leader()
            hs = [d.ha.node.metrics.histogram("commit_seconds")
                  for d in cluster.metas.values()]
            h0 = [list(h._counts) for h in hs]
            before = service_counts()
            fused_kernel.launches.reset()
            since = time.time()
            secs, retried_a = put_all(ec, names, datas, threads)
            launches = fused_kernel.launches.count
            svc_d = service_delta(before)
            check_launches_equal("ha (a) EC PUT through the ring", device, launches, svc_d)
            commit = hist_window(hs, h0)
            n_sub, sub_s = span_stat(since, "om:submit")
            gib_s = n_ec * ec_size / secs / gib
            print(f"ha (a): {n_ec} x {ec_size >> 20} MiB {rs} PUT on {threads} threads "
                  f"through the ring (leader {leader} at the start) in {secs:.3f} s = "
                  f"{gib_s:.3f} GiB/s; raft commit_seconds on the leaders: {commit['n']} "
                  f"proposals, p50 "
                  f"{1e3 * commit['p50']:.3f} ms, p99 {1e3 * commit['p99']:.3f} ms "
                  f"(every append fsync'd); om:submit {n_sub} spans, "
                  f"{1e3 * sub_s / max(1, n_sub):.3f} ms mean; kernel launches {launches}, "
                  f"service dispatches {svc_d['dispatches']}")
            print(f"ha (a) spans: {span_totals(since)}")
            print(f"ha (a): keys written again after a failed attempt: {retried_a}; "
                  + elections(cluster))
            lead_om = cluster.metas[cluster.await_leader()].om
            chunks = 0
            for name, data in zip(names, datas):
                info = lead_om.lookup_key("ha", "ec", name)
                groups = lead_om.key_block_groups(info)
                chunks += check_ec_units(lambda dn_id: by_id[dn_id].dn, groups, data, bpc,
                                         f"ha {name}", crc_route="native")
            print(f"ha (a): {chunks} chunks' data, parity and CRC words equal the numpy "
                  "coder's and the host CRC32C (native route)")
            out["launches"]["ha_put"] = launches
            out["a"] = dict(gib_s=gib_s, seconds=secs, commit_p50_s=commit["p50"],
                            commit_p99_s=commit["p99"], proposals=commit["n"],
                            om_submit_n=n_sub, om_submit_s=sub_s, chunks=chunks)

            # ---- (b) the leader stops under writes
            once(oz.om.create_bucket, "ha", "failover", rs)
            fb = vol.get_bucket("failover")
            fnames = [f"fo-{i}" for i in range(n_fail)]
            fdatas = [np.frombuffer(rng.bytes(fail_size), np.uint8) for _ in fnames]
            acks: list = []
            lock = threading.Lock()
            fourth = threading.Event()
            stop_t: dict = {}

            def on_ack(i):
                with lock:
                    acks.append((time.perf_counter(), fnames[i]))
                    if len(acks) == 4:
                        fourth.set()

            def stopper():
                fourth.wait(600)
                stop_t["id"] = cluster.await_leader()
                stop_t["t0"] = time.perf_counter()
                cluster.stop_meta(stop_t["id"])
                stop_t["t1"] = time.perf_counter()

            # the replica that answered each key's CommitKey: the failover
            # ends at the first key the new leader committed and answered
            answered: dict = {}

            def recording(rid, commit_key):
                def wrapped(session, groups, size, **kw):
                    commit_key(session, groups, size, **kw)
                    answered[session.key] = rid

                return wrapped

            for rid, d in cluster.metas.items():
                d.om.commit_key = recording(rid, d.om.commit_key)
            st = threading.Thread(target=stopper)
            st.start()
            r0 = resilience.METRICS.counter("retries_slept").value
            before = service_counts()
            fused_kernel.launches.reset()
            secs, retried_keys = put_all(fb, fnames, fdatas, threads, on_ack)
            st.join(60)
            launches = fused_kernel.launches.count
            svc_d = service_delta(before)
            for d in cluster.metas.values():
                d.om.__dict__.pop("commit_key", None)
            check_launches_equal("ha (b) PUT across the failover", device, launches, svc_d)
            retried_rpcs = resilience.METRICS.counter("retries_slept").value - r0
            new_leader = cluster.await_leader()
            leader = stop_t["id"]
            print("ha (b): " + elections(cluster))
            after = sorted(t for t, n in acks
                           if t > stop_t["t0"] and answered.get(n) == new_leader)
            if new_leader == leader or not after:
                raise AssertionError(f"ha (b): no key acknowledged by the new leader "
                                     f"(leader {leader} -> {new_leader})")
            failover_s = after[0] - stop_t["t0"]
            stop_s = stop_t["t1"] - stop_t["t0"]
            by_old = sum(1 for t, n in acks
                         if t > stop_t["t0"] and answered.get(n) == leader)
            # every acknowledged key reads back byte-exact from the new leader
            acked = {n for _, n in acks}
            if acked != set(fnames):
                raise AssertionError(f"ha (b): keys never acknowledged: "
                                     f"{set(fnames) - acked}")
            listed = {k["name"] for k in cluster.metas[new_leader].om.list_keys(
                "ha", "failover")}
            if listed != set(fnames):
                raise AssertionError(f"ha (b): acknowledged keys lost: {acked - listed}")
            for name, data in zip(fnames, fdatas):
                if not np.array_equal(fb.read_key(name), data):
                    raise AssertionError(f"ha (b): {name} read back differs")
            leader_node = cluster.metas[new_leader].ha.node
            snap = len(json.dumps(cluster.metas[new_leader].ha._snapshot_all()))
            print(f"ha (b): {n_fail} x {fail_size >> 20} MiB on {threads} threads in "
                  f"{secs:.3f} s; leader {leader} stopped after the 4th acknowledged key "
                  f"({stop_s:.3f} s to stop; {by_old} keys the old leader committed "
                  f"were acknowledged after the stop began), new leader {new_leader} "
                  f"(term {leader_node.storage.term}); failover {failover_s:.3f} s to the "
                  f"first key it committed and acknowledged; retried: {retried_keys} keys, "
                  f"{retried_rpcs} RPC backoffs; every key acknowledged and read back "
                  f"byte-exact from the new leader; kernel launches {launches}, service "
                  f"dispatches {svc_d['dispatches']}; ring snapshot {snap} B against the "
                  f"RPC's {rpc.MAX_MESSAGE} B frame limit")
            if snap >= rpc.MAX_MESSAGE:
                raise AssertionError("ha: the ring's snapshot exceeds the frame limit")
            t0 = time.perf_counter()
            cluster.revive_meta(leader)
            revived = cluster.metas[leader].ha.node
            wait_for("the revived replica caught up",
                     lambda: revived.last_applied >= leader_node.last_applied, 60,
                     poll_s=0.01)
            catchup_s = time.perf_counter() - t0
            def in_sync():
                ns = [d.ha.node for d in cluster.metas.values()]
                hints = {n.node_id if n.is_leader else n.leader_hint for n in ns}
                return len({n.last_applied for n in ns}) == 1 and len(hints) == 1 \
                    and None not in hints

            wait_for("three members in sync", in_sync, 30)
            views = [cli_json("admin", "ring-status", "--om", cluster.peers[m])
                     for m in sorted(cluster.metas)]
            print("ha (b): ring-status " + "; ".join(
                f"{v['replica_id']} {v['role']} term {v['term']} applied "
                f"{v['last_applied']} leader {v['leader']}" for v in views))
            if {len(v["members"]) for v in views} != {3} or \
                    len({v["last_applied"] for v in views}) != 1 or \
                    len({v["leader"] for v in views}) != 1:
                raise AssertionError(f"ha (b): ring-status not three members in sync: {views}")
            print(f"ha (b): the revived {leader} caught up in {catchup_s:.3f} s "
                  f"(log to index {revived.last_applied})")
            out["launches"]["ha_put_failover"] = launches
            out["b"] = dict(failover_s=failover_s, stop_s=stop_s, catchup_s=catchup_s,
                            retried_keys=retried_keys, retried_rpcs=retried_rpcs,
                            seconds=secs, snapshot_bytes=snap)

            # ---- (c) RATIS/THREE through the pipeline rings
            once(oz.om.create_bucket, "ha", "ratis", "RATIS/THREE")
            rb = vol.get_bucket("ratis")
            rnames = [f"r-{i}" for i in range(n_ratis)]
            rdatas = [np.frombuffer(rng.bytes(ratis_size), np.uint8) for _ in rnames]
            rtt: dict = {}
            orig_submit = ratis_client.XceiverClientRatis.submit

            def timed_submit(self, request, timeout=30.0):
                t = time.perf_counter()
                try:
                    return orig_submit(self, request, timeout)
                finally:
                    with lock:
                        rtt.setdefault(request.get("verb"), []).append(
                            time.perf_counter() - t)

            ratis_client.XceiverClientRatis.submit = timed_submit
            since = time.time()
            try:
                first_s, _ = put_all(rb, rnames[:2], rdatas[:2], 1)
                info = cluster.metas[cluster.await_leader()].om.lookup_key(
                    "ha", "ratis", rnames[1])
                pipe = info["block_groups"][0]
                members = list(pipe["nodes"])
                raft_leader = next((m for m in members if by_id[m].xceiver_ratis.leader_of(
                    int(pipe["pipeline_id"])) == m), None)
                victim = next(m for m in members if m != raft_leader)
                by_id[victim].stop()
                cluster.datanodes.remove(by_id[victim])
                rest_s, _ = put_all(rb, rnames[2:], rdatas[2:], 3)
            finally:
                ratis_client.XceiverClientRatis.submit = orig_submit
            for name, data in zip(rnames, rdatas):
                if not np.array_equal(rb.read_key(name), data):
                    raise AssertionError(f"ha (c): {name} read back differs")
                info = cluster.metas[cluster.await_leader()].om.lookup_key(
                    "ha", "ratis", name)
                for g in cluster.metas[cluster.await_leader()].om.key_block_groups(info):
                    for m in g.pipeline.nodes:
                        if m != victim and by_id[m].dn.get_committed_block_length(
                                g.block_id) != g.length:
                            raise AssertionError(f"ha (c): {m} holds a short {name}")
            print(f"ha (c) spans: {span_totals(since)}")
            ratis_s = first_s + rest_s
            ratis_gib_s = n_ratis * ratis_size / ratis_s / gib
            stats = {v: (len(t), statistics.median(t)) for v, t in rtt.items()}
            print(f"ha (c): {n_ratis} x {ratis_size >> 20} MiB RATIS/THREE through the "
                  f"pipeline ring of {members} (raft leader {raft_leader}): 2 keys in "
                  f"{first_s:.3f} s, then {victim} stopped, {n_ratis - 2} keys on 3 threads "
                  f"with a majority in {rest_s:.3f} s; {ratis_gib_s:.3f} GiB/s over all; raft "
                  "round trips (client submit to applied answer) " + ", ".join(
                      f"{v} {n} x {1e3 * med:.3f} ms median" for v, (n, med) in
                      sorted(stats.items())) + "; every key read back byte-exact, the live "
                  "members hold every committed length")
            out["c"] = dict(gib_s=ratis_gib_s, seconds=ratis_s, victim=victim,
                            rtt_s={v: med for v, (_, med) in stats.items()})

            # ---- (d) a degraded GET of (a)'s keys, two datanodes down
            info = cluster.metas[cluster.await_leader()].om.lookup_key("ha", "ec", names[0])
            data_units = info["block_groups"][0]["nodes"][:6]
            second = next(m for m in data_units if m != victim)
            stop_server(by_id[second])
            before = service_counts()
            fused_kernel.launches.reset()
            t0 = time.perf_counter()
            for name, data in zip(names, datas):
                if not np.array_equal(ec.read_key(name), data):
                    raise AssertionError(f"ha (d): degraded {name} differs")
            secs = time.perf_counter() - t0
            launches = fused_kernel.launches.count
            svc_d = service_delta(before)
            check_launches_equal("ha (d) degraded GET", device, launches, svc_d)
            if device.type == "cuda" and launches < 1:
                raise AssertionError("ha (d): the degraded GET launched no decode")
            restart_server(by_id[second])
            failed = {}
            for d in cluster.datanodes:
                for k, v in d.failed_commands.items():
                    failed[k] = failed.get(k, 0) + v
            print(f"ha (d): degraded GET of {n_ec} x {ec_size >> 20} MiB with {victim} and "
                  f"{second} down in {secs:.3f} s = {n_ec * ec_size / secs / gib:.3f} GiB/s, "
                  f"byte-exact; decode launches {launches}, service dispatches "
                  f"{svc_d['dispatches']}; failed SCM commands on the datanodes {failed}")
            out["launches"]["ha_degraded_get"] = launches
            out["d"] = dict(gib_s=n_ec * ec_size / secs / gib, failed_commands=failed)
            oz.om.close()
            oz.clients.close()
            oz.ratis_clients.close()
        finally:
            cluster.shutdown()
    return out


# ------------------------------------------------------------ filesystem path
def fs_path(device, cell: int, bpc: int, seed: int, n_io: int = 8,
            io_size: int = 64 * MIB, threads: int = 4, n_http: int = 2,
            http_size: int = 64 * MIB, o3fs_size: int = 16 * MIB,
            md_files: int = 500, md_page: int = 100, hsync_parts: int = 4,
            hsync_part: int = 4 * MIB, n_small: int = 128,
            small_size: int = 3901, small_threads: int = 8) -> dict:
    """The filesystem namespace on a daemon cluster (an ScmOmDaemon, its
    background pass every 0.1 s, and 9 DatanodeDaemons on loopback, native
    lane), an FSO bucket at rs-6-3 on `device`:
    (a) TestDFSIO shape: `n_io` files of `io_size` under
        /benchmarks/TestDFSIO/io_data through RootedOzoneFileSystem on
        `threads` threads, read back on `threads` threads; each file's
        composite checksum (from the stored chunk CRCs, the kernel's words)
        equals the host CRC32C of its bytes.
    (b) HttpFS on the same client: `n_http` files of `http_size` by the
        two-step CREATE, OPEN whole and ranged, GETFILECHECKSUM, LISTSTATUS,
        RENAME, DELETE; a degraded OPEN with two datanodes of the first
        group stopped (the decode form); one `o3fs_size` write and read
        through libo3fs; GiB/s beside (a)'s.
    (c) mdtest-easy shape: `threads` directories of `md_files` empty files,
        created, stat'ed, and listed `md_page` at a time.
    (d) (c)'s tree renamed (one row) beside a one-file directory; every
        entry answers under the new path and none under the old; the tree
        deleted recursively with two of (a)'s files, and the daemon's
        directory-deleting pass timed until deleted_dirs is empty and those
        files' blocks are gone from the datanodes.
    (e) a RATIS/THREE file written as `hsync_parts` parts of `hsync_part`,
        hsync after each, a second client reading the synced length; the
        writer abandoned mid-part, `recover_lease` seals the last synced
        length, and the stale writer's next hsync is refused; an EC file's
        hsync is refused.
    (f) IO500 mdtest-hard shape: `freon fsg` and `freon fskg` (depth 3),
        `n_small` files of `small_size` each on `small_threads` threads,
        every file read back byte-exact; ops/s.
    Every read is byte-exact and launches equal service dispatches in every
    part that codes."""
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.gateway.fs import RootedOzoneFileSystem
    from ozone_tpu_torch.gateway.httpfs import HttpFSGateway
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.storage.ids import StorageError
    from ozone_tpu_torch.tools import freon
    from ozone_tpu_torch.utils import checksum
    from ozone_tpu_torch.utils.tracing import Tracer

    rs = f"rs-6-3-{cell // 1024}k"
    gib = float(1 << 30)
    rng = np.random.default_rng(seed)
    out: dict = {"launches": {}}
    from collections import deque

    tracer = Tracer.instance()
    tracer.spans.clear()
    gc.collect()
    # room for every span of the phase: its span sums are read from them
    tracer.spans = deque(maxlen=max(tracer.spans.maxlen, 100_000))

    def step(what, fn):
        """fn() with the phase's launch and dispatch counts: launches =
        dispatches; returns (result, seconds, launches)."""
        before = service_counts()
        fused_kernel.launches.reset()
        since, t0 = time.time(), time.perf_counter()
        res = fn()
        secs = time.perf_counter() - t0
        launches = fused_kernel.launches.count
        check_launches_equal(f"fs {what}", device, launches, service_delta(before))
        print(f"fs {what} spans: {span_totals(since)}")
        return res, secs, launches

    def parallel(fn, items, n):
        with ThreadPoolExecutor(n) as ex:
            return list(ex.map(fn, items))

    def code(fn) -> str:
        try:
            fn()
        except StorageError as e:
            return e.code
        return "no error"

    with codec_route(True), daemon_cluster(device, 9, cell, seed, "fs",
                                           background_interval_s=0.1,
                                           ratis=True) as (meta, dns, oz):
        om = oz.om
        by_id = {d.dn.id: d for d in dns}
        om.create_volume("fs")
        om.create_bucket("fs", "b", rs, "FILE_SYSTEM_OPTIMIZED")
        ofs = RootedOzoneFileSystem(oz)

        # ---- (a) TestDFSIO: one file per task
        io_dir = "/fs/b/benchmarks/TestDFSIO/io_data"
        io_paths = [f"{io_dir}/test_io_{i}" for i in range(n_io)]
        io_data = [np.frombuffer(rng.bytes(io_size), np.uint8) for _ in io_paths]
        _, w_s, w_l = step("(a) write", lambda: parallel(
            lambda i: ofs.create(io_paths[i], io_data[i]), range(n_io), threads))

        def read_one(i):
            with ofs.open(io_paths[i]) as f:
                got = f.read()
            if got != io_data[i].tobytes():
                raise AssertionError(f"fs (a): {io_paths[i]} read back differs")

        _, r_s, r_l = step("(a) read", lambda: parallel(read_one, range(n_io), threads))
        t0 = time.perf_counter()
        sums = [ofs.checksum(p) for p in io_paths]
        ck_s = time.perf_counter() - t0
        for i, ck in enumerate(sums):
            want = checksum.crc32c(io_data[i])
            if ck["algorithm"] != "COMPOSITE-CRC32C" or int(ck["checksum"], 16) != want \
                    or ck["length"] != io_size:
                raise AssertionError(f"fs (a): checksum of {io_paths[i]} {ck} is not the "
                                     f"host CRC32C {want:08x}")
        io_bytes = n_io * io_size
        out["a"] = dict(write_gib_s=io_bytes / w_s / gib, read_gib_s=io_bytes / r_s / gib,
                        checksum_s=ck_s / n_io)
        out["launches"]["fs_dfsio_write"] = w_l
        print(f"fs (a) TestDFSIO: {n_io} x {io_size >> 20} MiB through ofs on {threads} "
              f"threads: write {w_s:.3f} s = {out['a']['write_gib_s']:.3f} GiB/s ({w_l} "
              f"launches), read {r_s:.3f} s = {out['a']['read_gib_s']:.3f} GiB/s, "
              f"byte-exact; composite checksums = host CRC32C, {1e3 * ck_s / n_io:.1f} ms "
              "per file from chunk metadata")

        # ---- (b) HttpFS (WebHDFS) on the same client
        gw = HttpFSGateway(oz, replication=rs)
        gw.start()
        try:
            base = f"http://{gw.address}/webhdfs/v1"

            class _NoRedirect(urllib.request.HTTPRedirectHandler):
                def redirect_request(self, *a, **kw):
                    return None

            opener = urllib.request.build_opener(_NoRedirect)

            def call(method, path, data=None, **params):
                qs = "&".join(f"{k}={v}" for k, v in params.items())
                req = urllib.request.Request(f"{base}{path}?{qs}", data=data,
                                             method=method)
                try:
                    with opener.open(req, timeout=600) as r:
                        return r.status, r.read(), r.headers
                except urllib.error.HTTPError as e:
                    body = e.read()
                    e.close()
                    return e.code, body, e.headers

            h_paths = [f"/fs/b/httpfs/f{i}" for i in range(n_http)]
            h_data = [rng.bytes(http_size) for _ in h_paths]

            def create(i):
                st, _, hd = call("PUT", h_paths[i], op="CREATE")
                if st != 307:
                    raise AssertionError(f"fs (b): CREATE step 1 answered {st}")
                r = urllib.request.urlopen(urllib.request.Request(
                    hd["Location"], data=h_data[i], method="PUT"), timeout=600)
                if r.status != 201:
                    raise AssertionError(f"fs (b): CREATE step 2 answered {r.status}")

            _, hw_s, hw_l = step("(b) HttpFS CREATE", lambda: parallel(
                create, range(n_http), n_http))

            def open_all():
                for i, p in enumerate(h_paths):
                    st, body, _ = call("GET", p, op="OPEN")
                    if st != 200 or body != h_data[i]:
                        raise AssertionError(f"fs (b): OPEN {p} differs")

            _, hr_s, _ = step("(b) HttpFS OPEN", open_all)
            off, ln = http_size // 3 + 17, http_size // 2 + 3
            st, body, _ = call("GET", h_paths[0], op="OPEN", offset=off, length=ln)
            if st != 200 or body != h_data[0][off:off + ln]:
                raise AssertionError("fs (b): ranged OPEN differs")
            st, body, _ = call("GET", h_paths[0], op="GETFILECHECKSUM")
            ck = json.loads(body)["FileChecksum"]
            want = checksum.crc32c(np.frombuffer(h_data[0], np.uint8))
            if ck["algorithm"] != sums[0]["algorithm"] or int(ck["bytes"], 16) != want:
                raise AssertionError(f"fs (b): GETFILECHECKSUM {ck} is not {want:08x}")
            st, body, _ = call("GET", "/fs/b/httpfs", op="LISTSTATUS")
            listed = [(e["pathSuffix"], e["length"]) for e in
                      json.loads(body)["FileStatuses"]["FileStatus"]]
            if listed != [(f"f{i}", http_size) for i in range(n_http)]:
                raise AssertionError(f"fs (b): LISTSTATUS {listed}")
            # the degraded OPEN: two datanodes of the first group stopped
            info = om.lookup_key("fs", "b", "httpfs/f0")
            first = info["block_groups"][0]["nodes"]
            down = [first[1], first[4]]
            for n in down:
                stop_server(by_id[n])
            try:
                def degraded():
                    st, body, _ = call("GET", h_paths[0], op="OPEN")
                    if st != 200 or body != h_data[0]:
                        raise AssertionError("fs (b): degraded OPEN differs")

                _, hd_s, hd_l = step("(b) degraded OPEN", degraded)
                if device.type == "cuda" and hd_l < 1:
                    raise AssertionError("fs (b): the degraded OPEN launched no decode")
            finally:
                for n in down:
                    restart_server(by_id[n])
            st, body, _ = call("PUT", h_paths[1], op="RENAME",
                               destination="/fs/b/httpfs/renamed")
            if json.loads(body) != {"boolean": True}:
                raise AssertionError(f"fs (b): RENAME answered {st} {body!r}")
            st, body, _ = call("DELETE", "/fs/b/httpfs/renamed", op="DELETE")
            st2, _, _ = call("GET", "/fs/b/httpfs/renamed", op="GETFILESTATUS")
            if json.loads(body) != {"boolean": True} or st2 != 404:
                raise AssertionError("fs (b): DELETE did not remove the file")
            # libo3fs: the C client over the gateway
            import ctypes

            from ozone_tpu_torch.client import libo3fs

            lib = libo3fs.library()
            c_data = rng.bytes(o3fs_size)
            fs_h = lib.o3fsConnect(b"127.0.0.1", gw.port)
            t0 = time.perf_counter()
            f = lib.o3fsOpenFile(fs_h, b"/fs/b/o3fs/c.bin", libo3fs.O3FS_WRONLY, 0, 0, 0)
            if not f or lib.o3fsWrite(fs_h, f, c_data, len(c_data)) != len(c_data) \
                    or lib.o3fsCloseFile(fs_h, f) != 0:
                raise AssertionError("fs (b): libo3fs write failed")
            cw_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            f = lib.o3fsOpenFile(fs_h, b"/fs/b/o3fs/c.bin", libo3fs.O3FS_RDONLY, 0, 0, 0)
            buf = ctypes.create_string_buffer(len(c_data))
            got, pos = 0, 0
            while pos < len(c_data):
                got = lib.o3fsRead(fs_h, f, ctypes.byref(buf, pos), len(c_data) - pos)
                if got <= 0:
                    break
                pos += got
            lib.o3fsCloseFile(fs_h, f)
            cr_s = time.perf_counter() - t0
            lib.o3fsDisconnect(fs_h)
            if buf.raw != c_data:
                raise AssertionError("fs (b): libo3fs read back differs")
        finally:
            gw.stop()
        h_bytes = n_http * http_size
        out["b"] = dict(write_gib_s=h_bytes / hw_s / gib, read_gib_s=h_bytes / hr_s / gib,
                        degraded_gib_s=http_size / hd_s / gib,
                        o3fs_write_gib_s=o3fs_size / cw_s / gib,
                        o3fs_read_gib_s=o3fs_size / cr_s / gib)
        out["launches"]["fs_httpfs_create"] = hw_l
        out["launches"]["fs_httpfs_degraded_open"] = hd_l
        print(f"fs (b) HttpFS: {n_http} x {http_size >> 20} MiB two-step CREATE "
              f"{out['b']['write_gib_s']:.3f} GiB/s (ofs in (a): {out['a']['write_gib_s']:.3f}, "
              f"ratio {out['b']['write_gib_s'] / out['a']['write_gib_s']:.3f}), OPEN "
              f"{out['b']['read_gib_s']:.3f} GiB/s (ofs {out['a']['read_gib_s']:.3f}, ratio "
              f"{out['b']['read_gib_s'] / out['a']['read_gib_s']:.3f}); ranged OPEN, "
              f"GETFILECHECKSUM = host CRC32C, LISTSTATUS, RENAME, DELETE; degraded OPEN "
              f"with {down} down {out['b']['degraded_gib_s']:.3f} GiB/s, {hd_l} decode "
              f"launches; libo3fs {o3fs_size >> 20} MiB write "
              f"{out['b']['o3fs_write_gib_s']:.3f}, read {out['b']['o3fs_read_gib_s']:.3f} "
              "GiB/s, byte-exact")

        # ---- (c) mdtest-easy: empty files, one directory per process
        md = [[f"/fs/b/mdtest/proc{t}/file.mdtest.{t}.{i}" for i in range(md_files)]
              for t in range(threads)]
        _, mc_s, mc_l = step("(c) create", lambda: parallel(
            lambda t: [ofs.create(p, b"") for p in md[t]], range(threads), threads))

        def stat_all(t):
            for p in md[t]:
                st = ofs.get_file_status(p)
                if st.is_dir or st.length != 0:
                    raise AssertionError(f"fs (c): stat {p} {st}")

        t0 = time.perf_counter()
        parallel(stat_all, range(threads), threads)
        ms_s = time.perf_counter() - t0

        def list_all(t):
            seen, after, pages = [], "", 0
            while True:
                page, more = ofs.list_status_page(f"/fs/b/mdtest/proc{t}",
                                                  start_after=after, limit=md_page)
                pages += 1
                seen += [s.path.rpartition("/")[2] for s in page]
                if not more:
                    break
                after = seen[-1]
            if sorted(seen) != sorted(p.rpartition("/")[2] for p in md[t]):
                raise AssertionError(f"fs (c): listing of proc{t} differs")
            return pages

        t0 = time.perf_counter()
        pages = sum(parallel(list_all, range(threads), threads))
        ml_s = time.perf_counter() - t0
        n_md = threads * md_files
        out["c"] = dict(create_ops_s=n_md / mc_s, stat_ops_s=n_md / ms_s,
                        list_entries_s=n_md / ml_s)
        out["launches"]["fs_mdtest"] = mc_l
        print(f"fs (c) mdtest-easy: {threads} x {md_files} empty files: create "
              f"{out['c']['create_ops_s']:.1f} ops/s ({mc_l} launches), stat "
              f"{out['c']['stat_ops_s']:.1f} ops/s, list {pages} pages of {md_page} "
              f"{out['c']['list_entries_s']:.1f} entries/s")

        # ---- (d) rename and recursive delete
        ofs.create("/fs/b/single/only", b"x")
        t0 = time.perf_counter()
        ofs.rename("/fs/b/mdtest", "/fs/b/mdtest-renamed")
        tree_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ofs.rename("/fs/b/single", "/fs/b/single-renamed")
        one_s = time.perf_counter() - t0

        def moved(t):
            for p in md[t]:
                new = p.replace("/mdtest/", "/mdtest-renamed/", 1)
                if ofs.get_file_status(new).length != 0 or ofs.exists(p):
                    raise AssertionError(f"fs (d): {p} not moved to {new}")

        parallel(moved, range(threads), threads)
        doomed = io_paths[:2]
        doomed_groups = [om.key_block_groups(om.lookup_key(
            "fs", "b", p.split("/", 3)[3])) for p in doomed]
        t0 = time.perf_counter()
        ofs.delete("/fs/b/mdtest-renamed", recursive=True)
        for p in doomed:
            ofs.delete(p)
        store = meta.om.store

        def blocks_gone():
            for groups in doomed_groups:
                for g in groups:
                    for n in g.pipeline.nodes:
                        try:
                            by_id[n].dn.get_block(g.block_id)
                            return False
                        except StorageError:
                            pass
            return True

        dirs_s = wait_for("fs (d): deleted_dirs empty",
                          lambda: not list(store.iterate("deleted_dirs")), 120, 0.02)
        blocks_s = wait_for("fs (d): the deleted files' blocks gone", blocks_gone,
                            120, 0.05) + dirs_s
        if ofs.exists("/fs/b/mdtest-renamed") or any(ofs.exists(p) for p in doomed):
            raise AssertionError("fs (d): a deleted entry still answers")
        out["d"] = dict(rename_tree_s=tree_s, rename_one_s=one_s, purge_dirs_s=dirs_s,
                        purge_blocks_s=blocks_s)
        print(f"fs (d): rename of the {n_md}-entry tree {1e3 * tree_s:.2f} ms, of a "
              f"one-file directory {1e3 * one_s:.2f} ms; every entry answers under the new "
              f"path only; recursive delete + 2 files: deleted_dirs empty after "
              f"{dirs_s:.3f} s, their blocks gone from the datanodes after {blocks_s:.3f} s")

        # ---- (e) hsync and lease recovery (RATIS/THREE in the FSO bucket)
        b = oz.get_volume("fs").get_bucket("b")
        rclients = DatanodeClientFactory()
        reader = OzoneClient(RemoteOmClient(meta.address, clients=rclients), rclients,
                             device=device)
        rb = reader.get_volume("fs").get_bucket("b")
        parts = [np.frombuffer(rng.bytes(hsync_part), np.uint8)
                 for _ in range(hsync_parts + 1)]
        h = b.open_key("logs/hsync.log", "RATIS/THREE")
        sync_ms = []
        try:
            for i in range(hsync_parts):
                h.write(parts[i])
                t0 = time.perf_counter()
                h.hsync()
                sync_ms.append(1e3 * (time.perf_counter() - t0))
                want = np.concatenate(parts[:i + 1])
                if not np.array_equal(rb.read_key("logs/hsync.log"), want):
                    raise AssertionError(f"fs (e): second reader after hsync {i + 1} differs")
            h.write(parts[-1][:hsync_part // 2])  # never synced
            t0 = time.perf_counter()
            if not ofs.recover_lease("/fs/b/logs/hsync.log"):
                raise AssertionError("fs (e): recover_lease found no synced write")
            rl_s = time.perf_counter() - t0
            sealed = np.concatenate(parts[:hsync_parts])
            info = rb.lookup_key_info("logs/hsync.log")
            if info["size"] != sealed.size or "hsync_client_id" in info or \
                    not np.array_equal(rb.read_key("logs/hsync.log"), sealed):
                raise AssertionError("fs (e): not sealed at the last synced length")
            stale = code(h.hsync)
            if stale != "KEY_NOT_FOUND":
                raise AssertionError(f"fs (e): the stale writer's hsync answered {stale}")
        finally:
            reader.om.close()
            reader.clients.close()
        e = b.open_key("logs/ec.bin")
        e.write(parts[0][:MIB])
        ec_code = code(e.hsync)
        e.close()
        if ec_code != "NOT_SUPPORTED_OPERATION":
            raise AssertionError(f"fs (e): EC hsync answered {ec_code}")
        out["e"] = dict(hsync_ms=statistics.median(sync_ms), recover_lease_s=rl_s)
        print(f"fs (e): {hsync_parts} x {hsync_part / MIB:g} MiB RATIS/THREE with hsync "
              f"after each ({', '.join(f'{m:.1f}' for m in sync_ms)} ms), the second "
              f"client read every synced length byte-exact; recover_lease "
              f"{1e3 * rl_s:.2f} ms sealed {sealed.size} B; stale hsync {stale}; EC "
              f"hsync {ec_code}")

        # ---- (f) small files, IO500 mdtest-hard shape
        # fsg's bucket made FSO first (its mkdirs would make an OBS one)
        om.create_volume("freon-vol")
        om.create_bucket("freon-vol", "freon-ofs", rs, "FILE_SYSTEM_OPTIMIZED")
        fsg, fsg_s, fsg_l = step("(f) fsg", lambda: freon.fsg(
            oz, n_files=n_small, size=small_size, threads=small_threads,
            replication=rs).summary())
        fskg, fskg_s, fskg_l = step("(f) fskg", lambda: freon.fskg(
            oz, n_files=n_small, size=small_size, depth=3, threads=small_threads,
            replication=rs).summary())
        for rep in (fsg, fskg):
            if rep["failures"] or rep["ops"] != n_small:
                raise AssertionError(f"fs (f): {rep}")
        want4 = np.random.default_rng(4).integers(0, 256, small_size, dtype=np.uint8)
        want1 = np.random.default_rng(1).integers(0, 256, small_size, dtype=np.uint8)
        fb, kb = (oz.get_volume("freon-vol").get_bucket(x)
                  for x in ("freon-ofs", "freon-fso"))

        def check_small(i):
            if not np.array_equal(fb.read_key(f"d{i % 8}/f{i}"), want4):
                raise AssertionError(f"fs (f): fsg file {i} differs")
            parts_ = [f"d{(i >> (4 * d)) & 0xF}" for d in range(3)]
            if not np.array_equal(kb.read_key("/".join(parts_) + f"/f{i}"), want1):
                raise AssertionError(f"fs (f): fskg file {i} differs")

        parallel(check_small, range(n_small), small_threads)
        if om.bucket_info("freon-vol", "freon-ofs")["layout"] != "FILE_SYSTEM_OPTIMIZED":
            raise AssertionError("fs (f): fsg did not write into the FSO bucket")
        out["f"] = dict(fsg_ops_s=fsg["ops_per_s"], fskg_ops_s=fskg["ops_per_s"],
                        fsg_p99_ms=fsg["p99_ms"], fskg_p99_ms=fskg["p99_ms"])
        out["launches"]["fs_fsg"] = fsg_l
        out["launches"]["fs_fskg"] = fskg_l
        print(f"fs (f): fsg {n_small} x {small_size} B on {small_threads} threads "
              f"{fsg['ops_per_s']} ops/s (create + read back, p99 {fsg['p99_ms']} ms, "
              f"{fsg_l} launches), fskg depth 3 {fskg['ops_per_s']} ops/s (p99 "
              f"{fskg['p99_ms']} ms, {fskg_l} launches); every file read back byte-exact")
    return out


# ---------------------------------------------------------------- security
def repair_onto_spare(meta, dns, by_id, victim: str, device, bpc: int, what: str,
                      how: str, on_dead=None) -> dict:
    """The victim datanode dies (stopped, its heartbeat far in the past, the
    SCM's liveness sweep declares it DEAD) and the SCM's reconstruction
    commands rebuild each of its EC units on a survivor: every rebuilt
    chunk must equal the lost one with CRCs equal to the host CRC32C, the
    rebuilt containers CLOSED, no command failed, and the step's kernel
    launches equal the service's dispatches (and be more than none on the
    card). `on_dead()` runs once the node is DEAD, inside the timed and
    counted window (it must launch nothing). Returns its launches,
    seconds and MiB/s per target."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.scm.node_manager import NodeState
    from ozone_tpu_torch.storage.ids import ContainerState
    from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

    vdn = by_id[victim].dn
    lost, index = {}, {}  # the victim's EC units: (chunks, bytes), replica index
    for c0 in vdn.list_containers():
        if c0.replica_index <= 0:
            continue  # a replicated container: re-replicated, not rebuilt
        index[c0.id] = c0.replica_index
        for b in vdn.list_blocks(c0.id):
            lost[b.block_id] = [(ch, vdn.read_chunk(b.block_id, ch).copy())
                                for ch in b.chunks]
    by_id[victim].stop()
    meta.scm.nodes.get(victim).last_heartbeat = -1e9
    meta.scm.nodes.check_liveness()
    if meta.scm.nodes.get(victim).state is not NodeState.DEAD:
        raise AssertionError(f"{victim} not DEAD")
    before = service_counts()
    fused_kernel.launches.reset()
    t0 = time.perf_counter()
    if on_dead is not None:
        on_dead()

    def holder(bid):
        with meta.scm_service.lock:
            c0 = meta.scm.containers.get(bid.container_id)
            held = [dn for dn, r in c0.replicas.items() if dn != victim and
                    r.replica_index == index[bid.container_id]
                    and r.state == "CLOSED"]
        return held[0] if len(held) == 1 else None

    wait_for(f"{what}: the reconstruction", lambda: all(
        holder(bid) for bid in lost), 120, poll_s=0.05)
    repair_s = time.perf_counter() - t0
    launches = fused_kernel.launches.count
    svc = service_delta(before)
    host = Checksum(ChecksumType.CRC32C, bpc)
    per_target: dict[str, int] = {}
    for bid, chunks in lost.items():
        dst = by_id[holder(bid)].dn
        if dst.containers.get(bid.container_id).state is not ContainerState.CLOSED:
            raise AssertionError(f"rebuilt container {bid.container_id} not CLOSED")
        got = dst.get_block(bid).chunks
        if [(i.offset, i.length) for i, _ in chunks] != [(i.offset, i.length)
                                                         for i in got]:
            raise AssertionError(f"rebuilt chunk list of {bid} differs")
        for (_, want), i in zip(chunks, got):
            data = dst.read_chunk(bid, i)
            if not np.array_equal(data, want) or \
                    host.compute(data).checksums != i.checksum.checksums:
                raise AssertionError(f"rebuilt chunk {i.name} differs")
            per_target[holder(bid)] = per_target.get(holder(bid), 0) + i.length
    failed = {d.dn.id: d.failed_commands for d in dns if d.failed_commands}
    if failed or not per_target:
        errors = []
        for d in dns:
            for c, e in d.command_errors[-3:]:
                cid = getattr(c, "container_id", None)
                with meta.scm_service.lock:
                    c0 = meta.scm.containers.get_or_none(cid) if cid else None
                    reps = ({dn: (r.state, r.replica_index)
                             for dn, r in c0.replicas.items()} if c0 else None)
                local = {x.dn.id: (x.dn.containers.get(cid).state.value,
                                   x.dn.containers.get(cid).replica_index)
                         for x in dns if cid is not None
                         and cid in {cc.id for cc in x.dn.list_containers()}}
                errors.append(f"{d.dn.id}: {c!r}: {e!r}; the SCM's replicas {reps}; "
                              f"held {local}")
        raise AssertionError(f"repair: failed commands {failed}, rebuilt {per_target}; "
                             f"errors {errors}")
    rates = {t: n / repair_s / MIB for t, n in per_target.items()}
    print(f"{what}: {victim} DEAD, {len(lost)} blocks rebuilt {how} in {repair_s:.3f} s: "
          + ", ".join(f"{t} {per_target[t]} B = {r:.1f} MiB/s"
                      for t, r in sorted(rates.items()))
          + " per target (wall, from the death); every rebuilt chunk equals the lost "
          f"one, CRCs equal host CRC32C; failed commands {failed}")
    check_launches_equal(what, device, launches, svc)
    if device.type == "cuda" and launches <= 0:
        raise AssertionError(f"{what} launched no decode")
    return {"launches": launches, "seconds": repair_s, "mib_s_per_target": rates}


def crypto_check() -> str:
    """What the encryption path runs on: the `cryptography` package (AES for
    the KMS, x509 for the CA; found and its version read from its
    metadata, the port imports it where it uses it) and Python's `ssl`
    (mutual TLS). Raises when either is missing: nothing falls back."""
    import importlib.metadata
    import importlib.util
    import ssl

    if importlib.util.find_spec("cryptography") is None:
        raise AssertionError("no cryptography package: the KMS and the CA need it")
    if not ssl.HAS_TLSv1_3:
        raise AssertionError(f"Python's ssl ({ssl.OPENSSL_VERSION}) has no TLS 1.3")
    return (f"cryptography {importlib.metadata.version('cryptography')}; Python ssl "
            f"module {ssl.OPENSSL_VERSION}")


class _Fixed:
    """A token store that hands out one chosen token for every verb."""

    def __init__(self, tok):
        self.tok = tok

    def block_token(self, block_id):
        return self.tok

    def container_token(self, container_id):
        return self.tok


def lane_refusals(meta, dns, ec_group, ratis_group, cell: int) -> dict:
    """On each datanode lane (the RPC verbs, the native sidecar, the RATIS
    pipeline's Submit) six bad requests: no token, a forged signature, an
    expired token, a READ token used to write, block A's token on block B
    and a container token for another container (where a lane has no
    container verb, presented as the stream's token). Each must be refused
    with BLOCK_TOKEN_VERIFICATION_FAILED and leave the container as it was.
    Returns the refusals by reason."""
    from ozone_tpu_torch.client.native_dn import NativeDatanodeClient
    from ozone_tpu_torch.net.dn_service import RpcDatanodeClient
    from ozone_tpu_torch.net.ratis_service import RemoteRatisClient
    from ozone_tpu_torch.storage.ids import (
        BLOCK_TOKEN_VERIFICATION_FAILED,
        BlockData,
        BlockID,
        ChunkInfo,
        StorageError,
    )
    from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType
    from ozone_tpu_torch.utils.security import AccessMode, BlockTokenIssuer

    keys = meta.scm.secret_keys
    reasons: dict[str, int] = {}
    by_id = {d.dn.id: d for d in dns}
    data = np.random.default_rng(99).integers(0, 256, cell, dtype=np.uint8)
    info0 = ChunkInfo("x", 0, cell, Checksum(ChecksumType.CRC32C, 16 * 1024).compute(data))
    rw = [AccessMode.READ, AccessMode.WRITE]
    for lane, g in (("rpc", ec_group), ("native", ec_group), ("ratis", ratis_group)):
        cid = g.container_id
        # a member that holds the container (a RATIS member may still be
        # applying its create)
        d = next(by_id[n] for n in g.pipeline.nodes
                 if cid in {c.id for c in by_id[n].dn.list_containers()})
        bid = BlockID(cid, g.local_id + 100_000)  # a block no one wrote
        info = ChunkInfo(f"{bid}_chunk_0", 0, cell, info0.checksum)
        for case in ("none", "forged", "expired", "read_for_write", "other_block",
                     "other_container"):
            tok = None
            if case == "forged":
                tok = dict(BlockTokenIssuer(keys).issue(bid, rw))
                tok["sig"] = ("0" if tok["sig"][0] != "0" else "1") + tok["sig"][1:]
            elif case == "expired":
                tok = BlockTokenIssuer(keys, token_lifetime_s=-60.0).issue(bid, rw)
            elif case == "read_for_write":
                tok = BlockTokenIssuer(keys).issue(bid, [AccessMode.READ])
            elif case == "other_block":
                tok = BlockTokenIssuer(keys).issue(BlockID(cid, bid.local_id + 1), rw)
            elif case == "other_container":
                tok = BlockTokenIssuer(keys).issue_container(cid + 1000)
            c = d.dn.containers.get(cid)
            before = (c.state, sorted((b.block_id.local_id, len(b.chunks))
                                      for b in d.dn.list_blocks(cid)),
                      d.dn.metrics.counter("bytes_written").value)
            try:
                if lane == "rpc":
                    cl = RpcDatanodeClient(d.dn.id, d.address, tokens=_Fixed(tok))
                    try:
                        if case == "other_container":
                            cl.close_container(cid)
                        else:
                            cl.write_chunk(bid, info, data)
                    finally:
                        cl.close()
                elif lane == "native":
                    cl = NativeDatanodeClient(d.dn.id, d.address, tokens=_Fixed(tok))
                    try:
                        cl.write_chunks_commit(bid, [(info, data)],
                                               commit=BlockData(bid, [info]))
                    finally:
                        cl.close()
                else:
                    cl = RemoteRatisClient(d.dn.id, d.address)
                    if case == "other_container":
                        req = {"verb": "close_container", "container_id": cid,
                               "container_token": tok}
                    else:
                        req = {"verb": "write_chunk_commit", "block_id": bid.to_json(),
                               "offset": 0, "length": cell}
                        if tok is not None:
                            req["token"] = tok
                    cl.submit(g.pipeline.id, req, timeout=5.0)
            except StorageError as e:
                if e.code != BLOCK_TOKEN_VERIFICATION_FAILED:
                    raise AssertionError(f"{lane} {case}: refused with {e.code}: {e.msg}")
                why = ("token is for another subject" if e.msg.startswith("token is for")
                       else e.msg)
                reasons[why] = reasons.get(why, 0) + 1
            else:
                raise AssertionError(f"{lane} {case}: served")
            after = (c.state, sorted((b.block_id.local_id, len(b.chunks))
                                     for b in d.dn.list_blocks(cid)),
                     d.dn.metrics.counter("bytes_written").value)
            if after != before:
                raise AssertionError(f"{lane} {case}: the container changed: {before} -> {after}")
    return reasons


def security_path(device, cell: int, bpc: int, seed: int, n_tenants: int = 2,
                  users_per_tenant: int = 2, single_cells: int = 64,
                  multi_cells: int = 96) -> dict:
    """A multi-tenant S3 store with block tokens and native ACLs (Apache
    Ozone's feature/S3-Multi-Tenancy.md with hdds.block.token.enabled and
    ozone.acl.enabled): an ScmOmDaemon with `block_tokens=True,
    insecure_secrets=True` (the keys ride Register and Heartbeat in the
    clear; `encryption_path` runs the same tokens over mutual TLS) and ACLs on (superuser root), 9
    DatanodeDaemons on 3 racks each with its native sidecar, rs-6-3 at
    `cell` with CRC32C per `bpc`, and an S3Gateway with require_auth.
    (a) `n_tenants` tenants of `users_per_tenant` users each PUT a
    `single_cells` object and upload a `multi_cells` + 12 345 B object in
    8-cell parts, then GET them whole and ranged; a degraded GET with two
    datanodes' servers down. The same PUTs and GETs also run on a cluster
    with tokens and ACLs off: the ratio is what security costs. (b) A
    user's PUT and GET into another tenant's bucket (the reference answers
    NoSuchBucket: the tenants' bucket namespaces are apart), a canned
    public-read `?acl` letting an anonymous GET through and `private`
    turning it away, the `?acl` body read back as set, HttpFS GETACLSTATUS
    and CHECKACCESS. (c) Every lane's six refusals. (d) A secret-key
    rotation under load: reads under tokens of the old key, the first
    write under the new one. (e) One datanode dies and the SCM-driven
    reconstruction rebuilds its units with tokens the datanode signs
    itself onto a spare that joins. (f) A delegation token got, used by a
    second client through the remote OM (a listing and a read under the
    token owner's ACL grant), the token-authenticated caller's request for
    another refused, renewed, cancelled, and refused after the cancel.
    Every body is byte-exact and kernel launches equal the codec
    service's dispatches in every coding step."""
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.gateway.httpfs import HttpFSGateway
    from ozone_tpu_torch.gateway.s3 import S3Gateway
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.net.ratis_service import RatisClientFactory
    from ozone_tpu_torch.net.scm_service import RemoteScmClient
    from ozone_tpu_torch.storage.ids import StorageError
    from ozone_tpu_torch.utils import security

    rs = f"rs-6-3-{cell // 1024}k"
    part = 8 * cell
    rng = np.random.default_rng(seed + 14)
    tenants = [f"t{i + 1}" for i in range(n_tenants)]
    users = [(t, f"{t}u{j}") for t in tenants for j in range(users_per_tenant)]
    singles = {u: rng.integers(0, 256, single_cells * cell, dtype=np.uint8).tobytes()
               for _, u in users}
    multis = {u: rng.integers(0, 256, multi_cells * cell + 12345, dtype=np.uint8).tobytes()
              for _, u in users}
    put_bytes = sum(map(len, singles.values())) + sum(map(len, multis.values()))
    out: dict = {"launches": {}}

    def md5(b) -> str:
        return hashlib.md5(b).hexdigest()

    def step(what: str, fn, items, key=None, codes: bool = False):
        """fn over items concurrently: (results, seconds); launches equal
        dispatches, and a step that `codes` (a PUT, a decode) launched."""
        before = service_counts()
        fused_kernel.launches.reset()
        t0 = time.perf_counter()
        res = concurrent(fn, items)
        secs = time.perf_counter() - t0
        launches = fused_kernel.launches.count
        svc = service_delta(before)
        check_launches_equal(what, device, launches, svc)
        if key is not None:
            out["launches"][key] = launches
        if codes and device.type == "cuda" and launches <= 0:
            raise AssertionError(f"{what} launched no kernel")
        return res, secs

    def cluster(root: Path, secured: bool):
        """(meta, dns, client, gateway, admin om) of one cluster."""
        meta = ScmOmDaemon(root / "om.db", block_size=16 * cell, container_size=1024 * cell,
                           stale_after_s=30.0, dead_after_s=60.0, background_interval_s=0.5,
                           placement_seed=seed, device=device, block_tokens=secured,
                           insecure_secrets=secured, acl_enabled=secured)
        if secured:
            # sign with a new key 2 s after it is made (the heartbeat is 0.5 s;
            # the SCM's default waits 10 s), so the rotation step stays short
            meta.scm.secret_keys.activation_s = 2.0
        meta.start()
        dns = []
        for i in range(9):
            d = DatanodeDaemon(root / f"dn{i}", f"dn{i}", meta.address, rack=f"/rack{i % 3}",
                               heartbeat_interval_s=0.5, device=device)
            d.start()
            dns.append(d)
        scm = RemoteScmClient(meta.address)
        try:
            wait_for("9 datanodes registered", lambda: len(scm.status()["nodes"]) == 9, 30)
        finally:
            scm.close()
        if secured:
            wait_for("every datanode enforcing, with the keys", lambda: all(
                d.verifier.enabled and d.secrets.export_keys() for d in dns), 30)
        clients = DatanodeClientFactory()
        om = RemoteOmClient(meta.address, clients=clients)
        for d in dns:
            clients.register_remote(d.dn.id, d.address)
        oz = OzoneClient(om, clients, device=device, ratis_clients=RatisClientFactory(
            address_source=clients.remote_address))
        gw = S3Gateway(oz, replication=rs, require_auth=True)
        gw.start()
        return meta, dns, oz, gw, om

    def teardown(meta, dns, oz, gw, om):
        gw.stop()
        oz.ratis_clients.close()
        om.close()
        oz.clients.close()
        for d in dns:
            d.stop()
        meta.stop()

    def tenant_traffic(meta, gw, om, tag: str, ranged: bool) -> tuple[dict, dict]:
        """Tenants, users and their S3 PUTs and GETs; (rates, clients)."""
        with om.user_context("root"):
            for t in tenants:
                om.create_tenant(t)
            creds = {u: om.tenant_assign_user(t, u) for t, u in users}
        cl = {u: S3Client(gw.address, creds[u]["access_id"], creds[u]["secret"])
              for _, u in users}
        for t in tenants:
            cl[f"{t}u0"].ok("PUT", f"/{t}-data")

        def put(tu):
            t, u = tu
            h, _ = cl[u].ok("PUT", f"/{t}-data/{u}/single", singles[u])
            etag, parts = s3_multipart(cl[u], f"/{t}-data/{u}/multi", multis[u], part, 4)
            want = [md5(multis[u][o:o + part]) for o in range(0, len(multis[u]), part)]
            from ozone_tpu_torch.om.multipart import _final_etag

            if h["etag"].strip('"') != md5(singles[u]) or parts != want or \
                    etag != _final_etag([{"etag": e} for e in want]):
                raise AssertionError(f"{tag} PUT {u}: ETags")

        def get(tu):
            t, u = tu
            for name, want in (("single", singles[u]), ("multi", multis[u])):
                if cl[u].ok("GET", f"/{t}-data/{u}/{name}")[1] != want:
                    raise AssertionError(f"{tag} GET {u}/{name}: bytes differ")

        _, put_s = step(f"security {tag} S3 PUT", put, users, f"security_{tag}_put",
                        codes=True)
        _, get_s = step(f"security {tag} S3 GET", get, users, f"security_{tag}_get")
        rates = {"put": put_bytes / put_s / 2**30, "get": put_bytes / get_s / 2**30}
        if ranged:
            n_rng = min(4, multi_cells // 8 - 1)  # ranges across part boundaries

            def ranged_get(tu):
                t, u = tu
                for j in range(n_rng):
                    lo = j * part + part // 2 + 777
                    _, data = cl[u].ok("GET", f"/{t}-data/{u}/multi", extra={
                        "Range": f"bytes={lo}-{lo + part - 1}"}, status=206)
                    if data != multis[u][lo:lo + part]:
                        raise AssertionError(f"{tag} ranged GET {u}")

            _, rg_s = step(f"security {tag} S3 ranged GET", ranged_get, users,
                           f"security_{tag}_ranged_get")
            rates["ranged_get"] = n_rng * part * len(users) / rg_s / 2**30
        print(f"security {tag}: {len(tenants)} tenants x {users_per_tenant} users, each a "
              f"{single_cells * cell} B PUT and a {multi_cells * cell + 12345} B multipart "
              f"upload in {part} B parts: {put_bytes} B PUT in {put_s:.3f} s = "
              f"{rates['put']:.3f} GiB/s, GET whole {get_s:.3f} s = {rates['get']:.3f} GiB/s"
              + (f", ranged {rates['ranged_get']:.3f} GiB/s" if ranged else "")
              + " (wall, this run); every body byte-exact")
        return rates, cl

    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-sec-") as tmp:
        root = Path(tmp)
        # (a') the same traffic with tokens and ACLs off
        c = cluster(root / "plain", secured=False)
        try:
            plain, _ = tenant_traffic(c[0], c[3], c[4], "unsecured", ranged=False)
        finally:
            teardown(*c)
        meta, dns, oz, gw, om = cluster(root / "secure", secured=True)
        by_id = {d.dn.id: d for d in dns}
        refs0 = {lane: security.METRICS.counter(f"refused_{lane}").value
                 for lane in ("rpc", "native", "ratis")}
        hist0 = {lane: (security.METRICS.histogram(f"verify_{lane}").count,
                        security.METRICS.histogram(f"verify_{lane}").total)
                 for lane in ("rpc", "native", "ratis")}
        ca0 = (meta.om.metrics.histogram("check_access").count,
               meta.om.metrics.histogram("check_access").total)
        try:
            # (a) the tenants' traffic, secured
            secured, cl = tenant_traffic(meta, gw, om, "secured", ranged=True)
            for k in ("put", "get"):
                print(f"security cost {k}: {secured[k]:.3f} GiB/s secured, {plain[k]:.3f} "
                      f"GiB/s unsecured = {secured[k] / plain[k]:.3f}x (wall, this run)")
            out["gib_s"], out["unsecured_gib_s"] = secured, plain
            t1, u0 = users[0]
            # (c) every lane refuses the six bad requests
            ratis_b = oz.get_volume(t1).create_bucket("rat", replication="RATIS/THREE")
            ratis_b.write_key("k", singles[u0][:4 * cell])
            ratis_g = om.key_block_groups(om.lookup_key(t1, "rat", "k"))[0]
            info = om.lookup_key(t1, f"{t1}-data", f"{u0}/multi")
            ec_g = om.key_block_groups(info)[0]
            reasons = lane_refusals(meta, dns, ec_g, ratis_g, cell)
            refused = {lane: security.METRICS.counter(f"refused_{lane}").value - refs0[lane]
                       for lane in refs0}
            if sorted(refused.values()) != [6, 6, 6]:
                raise AssertionError(f"refusals by lane: {refused}")
            print(f"security lanes: refusals by lane {refused}, by reason {reasons}; "
                  "BLOCK_TOKEN_VERIFICATION_FAILED each, no container changed")

            # a degraded GET: two holders of the first user's data units stop
            info = om.lookup_key(t1, f"{t1}-data", f"{u0}/multi")
            down = info["block_groups"][0]["nodes"][:2]
            for dn_id in down:
                stop_server(by_id[dn_id])
            def degraded(tu):
                t, u = tu
                if cl[u].ok("GET", f"/{t}-data/{u}/multi")[1] != multis[u]:
                    raise AssertionError(f"degraded GET {u}: bytes differ")

            _, deg_s = step("security degraded GET", degraded, users,
                            "security_degraded_get", codes=True)
            multi_b = sum(map(len, multis.values()))
            print(f"security degraded GET ({down} stopped): {multi_b} B byte-exact in "
                  f"{deg_s:.3f} s = {multi_b / deg_s / 2**30:.3f} GiB/s")
            for dn_id in down:
                restart_server(by_id[dn_id])

            # (b) refusals and grants
            t2, v0 = users[-1]
            ans = [cl[u0].req("GET", f"/{t2}-data/{v0}/single")[0],
                   cl[u0].req("PUT", f"/{t2}-data/intruder", b"x" * 100)[0]]
            plain_id = "chip-sec"
            secret = om.get_s3_secret(plain_id)
            pub = S3Client(gw.address, plain_id, secret)
            pub.ok("PUT", "/pub")
            pub.ok("PUT", "/pub/o", singles[u0][:cell])
            anon_before = pub.req("GET", "/pub/o", sign=False)[0]
            pub.ok("PUT", "/pub?acl", extra={"x-amz-acl": "public-read"})
            st, _, anon = pub.req("GET", "/pub/o", sign=False)
            body = (b'<AccessControlPolicy><AccessControlList><Grant><Grantee>'
                    b'<URI>http://acs.amazonaws.com/groups/global/AllUsers</URI></Grantee>'
                    b'<Permission>READ</Permission></Grant></AccessControlList>'
                    b'</AccessControlPolicy>')
            pub.ok("PUT", "/pub?acl", body)
            back = pub.ok("GET", "/pub?acl")[1]
            acl_back = (xml_text(back, "ID"), xml_text(back, "Permission"))
            pub.ok("PUT", "/pub?acl", extra={"x-amz-acl": "private"})
            st_private, _, err = pub.req("GET", "/pub/o", sign=False)
            if ans != [404, 404] or anon_before != 403 or st != 200 or \
                    anon != singles[u0][:cell] or acl_back != (["owner", "*"], ["READ"]) \
                    or st_private != 403 or xml_text(err, "Code") != ["AccessDenied"]:
                raise AssertionError(f"S3 refusals and grants: {ans} {anon_before} {st} "
                                     f"{acl_back} {st_private} {err[:200]!r}")
            print(f"security refusals: another tenant's bucket GET {ans[0]} and PUT {ans[1]} "
                  "NoSuchBucket (the tenants' namespaces are apart, as in the reference); "
                  f"anonymous GET 403 before a grant, {st} byte-exact under public-read, "
                  f"403 AccessDenied after private; ?acl read back {acl_back}")
            with om.user_context("root"):
                om.modify_acl("key", t1, f"{t1}-data", f"{u0}/single", op="add",
                              acls=["user:alice:r", "group:ops:rw[DEFAULT]"])
            hf = HttpFSGateway(oz)
            hf.start()
            try:
                import urllib.error
                import urllib.request

                base = f"http://{hf.address}/webhdfs/v1/{t1}/{t1}-data/{u0}/single"
                with urllib.request.urlopen(f"{base}?op=GETACLSTATUS") as r:
                    status = json.loads(r.read())["AclStatus"]
                with urllib.request.urlopen(
                        f"{base}?op=CHECKACCESS&fsaction=r--&user.name=alice") as r:
                    ok_code = r.status
                try:
                    urllib.request.urlopen(f"{base}?op=CHECKACCESS&fsaction=r--&user.name=eve")
                    denied = None
                except urllib.error.HTTPError as e:
                    denied = (e.code, json.loads(e.read())["RemoteException"]["exception"])
            finally:
                hf.stop()
            if status["entries"] != ["user:alice:r--", "default:group:ops:rw-"] or \
                    ok_code != 200 or denied != (403, "AccessControlException"):
                raise AssertionError(f"HttpFS ACL verbs: {status} {ok_code} {denied}")
            print(f"security HttpFS: GETACLSTATUS entries {status['entries']}; CHECKACCESS "
                  f"r-- alice {ok_code}, eve {denied}")

            # (d) a key rotation under load
            old_key = meta.scm.secret_keys.current().key_id
            old_info = om.lookup_key(t1, f"{t1}-data", f"{u0}/multi")
            rot_b = oz.get_volume(t1).get_bucket(f"{t1}-data")
            seen: list = []
            real_alloc = om.allocate_block

            def alloc(*a, **k):
                g = real_alloc(*a, **k)
                seen.append(g.token["key_id"])
                return g

            om.allocate_block = alloc
            try:
                t_rot = time.perf_counter()
                # a single-node SCM's rotation: mint a key and install it
                rotated = meta.scm.secret_keys.new_key()
                meta.scm.secret_keys.import_key(rotated)
                new_key = rotated.key_id
                n_put = 0
                while True:
                    del seen[:]
                    rot_b.write_key(f"rot/{n_put}", np.frombuffer(
                        singles[u0][:6 * cell], np.uint8))
                    n_put += 1
                    if seen and all(k == new_key for k in seen):
                        break
                    if time.perf_counter() - t_rot > 30:
                        raise AssertionError("no write under the new key in 30 s")
                rot_s = time.perf_counter() - t_rot
            finally:
                om.allocate_block = real_alloc
            if oz.get_volume(t1).get_bucket(f"{t1}-data").read_key_info(
                    old_info).tobytes() != multis[u0]:
                raise AssertionError("a read under the old key's tokens differs")
            if any(g.get("token", {}).get("key_id") != old_key
                   for g in old_info["block_groups"]):
                raise AssertionError("the old lookup's tokens are not the old key's")
            out["rotation_s"] = rot_s
            print(f"security rotation: key {old_key} -> {new_key}; first write under the new "
                  f"key {rot_s:.3f} s after the rotation ({n_put} PUTs of {6 * cell} B, "
                  "activation 2 s, heartbeat 0.5 s); a GET under tokens of the old key "
                  "byte-exact")

            # (e) the token-signed repair of a dead datanode onto a spare
            scm = RemoteScmClient(meta.address)
            try:
                # the EC containers: the repair rebuilds their units (the
                # RATIS one may hold a member whose server the degraded
                # step restarted, which `restart_server` leaves without
                # its raft transport, so it stays open and out of the way)
                ec_ids = {c["id"] for c in scm.list_containers()
                          if not c["replication"].startswith("RATIS")}
                for cid in sorted(ec_ids):
                    scm.admin("close-container", str(cid))
                wait_for("EC containers closed", lambda: all(
                    c["state"] == "CLOSED" and all(r["state"] == "CLOSED" for r in c["replicas"])
                    for c in scm.list_containers() if c["id"] in ec_ids), 30)
                spare = DatanodeDaemon(root / "secure" / "dn9", "dn9", meta.address,
                                       rack="/rack0", heartbeat_interval_s=0.5, device=device)
                spare.start()
                dns.append(spare)
                by_id["dn9"] = spare
                wait_for("the spare enforcing, with the keys",
                         lambda: spare.verifier.enabled and spare.secrets.export_keys(), 30)
            finally:
                scm.close()
            victim = info["block_groups"][0]["nodes"][2]
            rep = repair_onto_spare(meta, dns, by_id, victim, device, bpc,
                                    "security repair", "with tokens the datanodes "
                                    "signed themselves")
            out["launches"]["security_repair"] = rep["launches"]
            out["repair_mib_s_per_target"] = rep["mib_s_per_target"]

            # (f) delegation tokens through the remote OM
            with om.user_context("root"):
                om.modify_acl("bucket", t1, f"{t1}-data", op="add", acls=["user:alice:rl"])
            with om.user_context("alice"):
                tok = om.get_delegation_token("yarn")
            f2 = DatanodeClientFactory()
            job_om = RemoteOmClient(meta.address, clients=f2, token=tok)
            try:
                listed = [k["name"] for k in job_om.list_keys(t1, f"{t1}-data")]
                job = OzoneClient(job_om, f2, device=device)
                read = job.get_volume(t1).get_bucket(f"{t1}-data").read_key(
                    f"{u0}/single").tobytes()
                codes = []
                for fn in (lambda: job_om.get_delegation_token("yarn"),
                           lambda: job_om.delete_bucket(t1, f"{t1}-data")):
                    try:
                        fn()
                        codes.append("served")
                    except StorageError as e:
                        codes.append(e.code)
                with om.user_context("yarn"):
                    renewed = om.renew_delegation_token(tok)
                with om.user_context("alice"):
                    om.cancel_delegation_token(tok)
                try:
                    job_om.list_keys(t1, f"{t1}-data")
                    codes.append("served")
                except StorageError as e:
                    codes.append(e.code)
            finally:
                job_om.close()
                f2.close()
            if f"{u0}/single" not in listed or read != singles[u0] or \
                    codes != ["TOKEN_ERROR", "PERMISSION_DENIED", "TOKEN_ERROR"] or \
                    renewed < tok["issue"]:
                raise AssertionError(f"delegation tokens: {listed} {codes} {renewed}")
            print(f"security delegation token: alice's token listed {len(listed)} keys and "
                  f"read {len(read)} B byte-exact through a second client; a new token for "
                  f"the token's caller {codes[0]}, a delete beyond alice's grant {codes[1]}; "
                  f"renewed to {renewed}, cancelled, then {codes[2]}")

            # what security cost on each lane and in the OM; the daemons are
            # this cluster's own, so their chunk counters start at 0
            moved = sum(d.dn.metrics.counter(k).value for d in dns
                        for k in ("batched_write_chunks", "batched_read_chunks"))
            for lane in ("rpc", "native", "ratis"):
                h = security.METRICS.histogram(f"verify_{lane}")
                n, secs = h.count - hist0[lane][0], h.total - hist0[lane][1]
                extra = (f" = {1e6 * secs / max(moved, 1):.3f} us per chunk over the "
                         f"{moved} chunks the datanodes moved" if lane == "native" else "")
                print(f"security verify {lane}: {n} checks, {1e6 * secs / max(n, 1):.2f} us "
                      f"per check{extra}")
            n = meta.om.metrics.histogram("check_access").count - ca0[0]
            secs = meta.om.metrics.histogram("check_access").total - ca0[1]
            print(f"security check_access: {n} authorizer checks, "
                  f"{1e6 * secs / max(n, 1):.2f} us each; "
                  f"acl_denied {meta.om.metrics.counter('acl_denied').value}")
        finally:
            teardown(meta, dns, oz, gw, om)
    return out


def encryption_path(device, cell: int, bpc: int, seed: int, big_cells: int = 64,
                    n_big: int = 4, odd_cells: int = 96, n_ranged: int = 16,
                    part_cells: int = 8, n_renew: int = 6, gdpr_files: int = 4) -> dict:
    """Encryption at rest and in transit (Apache Ozone's security/SecuringTDE.md,
    security/GDPR.md and security/SecureOzone.md with hdds.grpc.tls.enabled):
    an ScmOmDaemon with `secure=True` (the cluster CA, mutual TLS on every
    channel, the CRL checked on every call) and block tokens, its
    enrollment endpoint gated by a secret; 9 DatanodeDaemons on 3 racks
    enroll there (no native sidecar: every chunk rides the TLS RPC), a 10th
    spare later; a remote OzoneClient with its own client certificate;
    rs-6-3 at `cell`, CRC32C per `bpc`. (a) A TDE bucket under master key
    mk1 and a plain one: `n_big` keys of `big_cells` cells and one of
    `odd_cells` cells + 12 345 B PUT concurrently into each and read back
    byte-exact (TDE+mTLS against plain+mTLS GiB/s, and the host's ctr_crypt
    GiB/s); every TDE data unit equals ctr_crypt of the source under the DEK
    kms_decrypt returns, none the plaintext, parity and CRCs the numpy
    coder's and the host CRC32C's over the ciphertext. (b) `n_ranged`
    ranged GETs of cell + 7 B at offsets off the AES block; an encrypted
    multipart upload in `part_cells`-cell parts through an in-process
    S3Gateway (require_auth, its own client certificate), read whole and
    across part boundaries. (c) A degraded GET of a TDE key with two
    holders stopped (the decode form on ciphertext), then one datanode
    dies and the SCM's reconstruction rebuilds its ciphertext onto the
    spare with tokens the datanodes sign. (d) mk1 rotated: a key written
    before and one after read back under EDEK versions 0 and 1. (e) GDPR:
    PUT, GET, delete, the row's secret erased in that apply, the raw
    chunks left on the datanodes are not the source; an FSO directory's
    recursive delete erases every child's secret. (f) Refusals with the
    reference's codes: no client certificate (UNAVAILABLE), a bad
    enrollment secret (IO_EXCEPTION), no token (BLOCK_TOKEN_VERIFICATION_
    FAILED), a revoked certificate (CERTIFICATE_REVOKED: seconds from the
    revoke to the first refusal at the metadata server and at a datanode);
    a datanode's certificate renewed live under PUTs with no failed call;
    ms per TLS handshake and seconds per datanode enrollment. Kernel
    launches equal the codec service's dispatches in every step, and no
    chunk rides a native stream."""
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.gateway.s3 import S3_VOLUME, S3Gateway
    from ozone_tpu_torch.net import rpc
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.net.dn_service import RpcDatanodeClient
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.net.scm_service import RemoteScmClient
    from ozone_tpu_torch.storage.ids import StorageError
    from ozone_tpu_torch.utils.ca import CertificateClient
    from ozone_tpu_torch.utils.kms import ctr_crypt

    secret = "chip-smoke-enroll"
    rs = f"rs-6-3-{cell // 1024}k"
    part = part_cells * cell
    rng = np.random.default_rng(seed + 15)
    keys = {f"k{i}": rng.integers(0, 256, big_cells * cell, dtype=np.uint8)
            for i in range(n_big)}
    keys["odd"] = rng.integers(0, 256, odd_cells * cell + 12345, dtype=np.uint8)
    total = sum(v.size for v in keys.values())
    out: dict = {"launches": {}}

    def step(what: str, fn, items, key=None, codes: bool = False):
        """fn over items concurrently: (results, seconds); launches equal
        dispatches, and a step that `codes` launched on the card."""
        before = service_counts()
        fused_kernel.launches.reset()
        t0 = time.perf_counter()
        res = concurrent(fn, items)
        secs = time.perf_counter() - t0
        launches = fused_kernel.launches.count
        check_launches_equal(what, device, launches, service_delta(before))
        if key is not None:
            out["launches"][key] = launches
        if codes and device.type == "cuda" and launches <= 0:
            raise AssertionError(f"{what} launched no kernel")
        return res, secs

    def refused(fn, code: str, what: str) -> None:
        try:
            fn()
        except StorageError as e:
            if e.code != code:
                raise AssertionError(f"{what}: {e.code} ({e.msg}), want {code}")
            return
        raise AssertionError(f"{what}: served, want {code}")

    def enrolled(root: Path, role: str):
        cc = CertificateClient(root, role)
        cc.enroll_remote(meta.enroll_address, secret=secret)
        return cc.tls()

    def remote_client(tls):
        clients = DatanodeClientFactory()
        clients.tls = tls
        for d in dns:
            clients.register_remote(d.dn.id, d.address)
        return OzoneClient(RemoteOmClient(meta.address, clients=clients, tls=tls),
                           clients, device=device)

    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-enc-") as tmp:
        root = Path(tmp)
        hs0 = rpc.METRICS.histogram("tls_handshake")
        hs0 = (hs0.count, hs0.total)
        meta = ScmOmDaemon(root / "om.db", block_size=16 * cell,
                           container_size=1024 * cell, stale_after_s=30.0,
                           dead_after_s=60.0, background_interval_s=0.5,
                           placement_seed=seed, device=device, block_tokens=True,
                           secure=True, enrollment_secret=secret)
        meta.start()
        dns: list = []
        oz = gw = gw_oz = None
        try:
            enroll_s = []
            for i in range(9):
                t0 = time.perf_counter()
                d = DatanodeDaemon(root / f"dn{i}", f"dn{i}", meta.address,
                                   rack=f"/rack{i % 3}", heartbeat_interval_s=0.5,
                                   device=device, ca_address=meta.enroll_address,
                                   enrollment_secret=secret)
                enroll_s.append(time.perf_counter() - t0)
                # the reference checks every 60 s; 1 s keeps (f) short
                d.cert_renewal.check_interval_s = 1.0
                d.start()
                dns.append(d)
            by_id = {d.dn.id: d for d in dns}
            wait_for("9 datanodes enforcing, with the keys", lambda: all(
                d.verifier.enabled and d.secrets.export_keys() for d in dns), 30)
            if any(d.datapath is not None for d in dns) or not all(
                    d.server.tls_enabled for d in dns + [meta]):
                raise AssertionError("a sidecar started, or a server without TLS")
            out["enroll_s"] = statistics.mean(enroll_s)
            print(f"encryption cluster: ScmOmDaemon secure (CA, mutual TLS, block "
                  f"tokens), 9 datanodes enrolled in {statistics.mean(enroll_s):.3f} s "
                  f"each (mean; min {min(enroll_s):.3f}, max {max(enroll_s):.3f}: key "
                  "pair, CSR, signed over the enrollment RPC, server bound); no sidecar")
            oz = remote_client(enrolled(root / "client", "client-smoke"))
            om = oz.om
            with om.user_context("root"):
                om.kms_create_key("mk1")
            oz.create_volume("enc")
            om.create_bucket("enc", "tde", rs, encryption_key="mk1")
            om.create_bucket("enc", "plain", rs)
            tde = oz.get_volume("enc").get_bucket("tde")
            plain = oz.get_volume("enc").get_bucket("plain")

            # (a) PUT and GET, TDE against plain over the same mutual TLS
            def put(b):
                return lambda name: b.write_key(name, keys[name])

            def get(b):
                def one(name):
                    if not np.array_equal(b.read_key(name), keys[name]):
                        raise AssertionError(f"GET {b.name}/{name}: bytes differ")
                return one

            rates = {}
            for tag, b in (("plain", plain), ("tde", tde)):
                _, put_s = step(f"encryption {tag} PUT", put(b), list(keys),
                                f"encryption_{tag}_put", codes=True)
                _, get_s = step(f"encryption {tag} GET", get(b), list(keys),
                                f"encryption_{tag}_get")
                rates[tag] = {"put": total / put_s / 2**30, "get": total / get_s / 2**30}
            c_times = []
            for _ in range(3):
                t0 = time.perf_counter()
                ctr_crypt(keys["k0"], b"\x07" * 32, b"\x01" * 16, 5)
                c_times.append(time.perf_counter() - t0)
            out["ctr_gib_s"] = keys["k0"].size / min(c_times) / 2**30
            out["gib_s"] = rates
            print(f"encryption (a): {len(keys)} keys, {total} B, concurrently over mutual "
                  f"TLS: PUT TDE {rates['tde']['put']:.3f} GiB/s, plain "
                  f"{rates['plain']['put']:.3f} = {rates['tde']['put'] / rates['plain']['put']:.3f}x; "
                  f"GET TDE {rates['tde']['get']:.3f}, plain {rates['plain']['get']:.3f} = "
                  f"{rates['tde']['get'] / rates['plain']['get']:.3f}x (wall, this run); "
                  f"host ctr_crypt {out['ctr_gib_s']:.3f} GiB/s on {keys['k0'].size} B "
                  "(best of 3, one thread); every body byte-exact")
            chunks = 0
            for name, src in keys.items():
                info = om.lookup_key("enc", "tde", name)
                enc = info["encryption"]
                dek = bytes.fromhex(om.kms_decrypt("enc", "tde", enc))
                cipher = ctr_crypt(src, dek, bytes.fromhex(enc["iv"]))
                same = (cipher[:src.size // cell * cell].reshape(-1, cell)
                        == src[:src.size // cell * cell].reshape(-1, cell)).all(axis=1)
                if same.any() or enc["master"] != "mk1" or enc["version"] != 0:
                    raise AssertionError(f"TDE {name}: a cell stored in the clear, or "
                                         f"a bad bundle {enc}")
                chunks += check_ec_units(lambda i: by_id[i].dn, om.key_block_groups(info),
                                         cipher, bpc, f"TDE unit check {name}",
                                         crc_route="native")
            print(f"encryption (a): {chunks} stored chunks of the TDE keys: data units "
                  "equal ctr_crypt of the source under the DEK kms_decrypt returns, no "
                  "cell equals the plaintext, parity equal the numpy coder's and CRC "
                  "words the host CRC32C over the ciphertext")

            # (b) ranged GETs off the AES block, and an encrypted multipart upload
            # through the S3 gateway (its own client certificate)
            odd = keys["odd"]
            offs = [int(o) for o in rng.integers(0, odd.size - cell - 7, n_ranged)]
            offs = [o + (3 if o % 16 == 0 else 0) for o in offs]

            def ranged(o):
                if not np.array_equal(tde.read_key_range("odd", o, cell + 7),
                                      odd[o:o + cell + 7]):
                    raise AssertionError(f"ranged GET at {o}: bytes differ")

            _, rg_s = step("encryption ranged GET", ranged, offs, "encryption_ranged_get")
            gw_oz = remote_client(enrolled(root / "s3g", "client-s3g"))
            gw = S3Gateway(gw_oz, replication=rs, require_auth=True)
            gw.start()
            om.create_bucket(S3_VOLUME, "tde-mpu", rs, encryption_key="mk1")
            s3 = S3Client(gw.address, "smoke", om.get_s3_secret("smoke"))
            body = odd.tobytes()
            res, mpu_s = step("encryption S3 multipart PUT",
                              lambda _: s3_multipart(s3, "/tde-mpu/obj", body, part, 4),
                              [0], "encryption_mpu_put", codes=True)
            etag, parts = res[0]
            mrow = om.lookup_key(S3_VOLUME, "tde-mpu", "obj")
            ivs = [p["iv"] for p in mrow["enc_parts"]]
            if len(ivs) != len(parts) or len(set(ivs)) != len(ivs) or \
                    [p["size"] for p in mrow["enc_parts"]] != [
                        min(part, len(body) - o) for o in range(0, len(body), part)]:
                raise AssertionError(f"multipart enc_parts: {mrow['enc_parts'][:3]}")
            n_cross = min(4, len(parts) - 1)

            def mpu_get(j):
                if j < 0:
                    if s3.ok("GET", "/tde-mpu/obj")[1] != body:
                        raise AssertionError("multipart GET: bytes differ")
                    return
                lo = (j + 1) * part - 777 - 13 * j
                got = s3.ok("GET", "/tde-mpu/obj", extra={
                    "Range": f"bytes={lo}-{lo + part}"}, status=206)[1]
                if got != body[lo:lo + part + 1]:
                    raise AssertionError(f"ranged multipart GET at {lo}")

            _, mg_s = step("encryption S3 multipart GET", mpu_get,
                           [-1] + list(range(n_cross)), "encryption_mpu_get")
            print(f"encryption (b): {n_ranged} ranged GETs of {cell + 7} B off the AES "
                  f"block in {rg_s:.3f} s; S3 multipart upload of {len(body)} B in "
                  f"{len(parts)} parts of {part} B (each its own IV, the row's enc_parts) "
                  f"in {mpu_s:.3f} s, ETag {etag}; GET whole and {n_cross} ranges across part boundaries "
                  f"byte-exact in {mg_s:.3f} s")

            # (c) a degraded GET of ciphertext, then the repair onto a spare
            info = om.lookup_key("enc", "tde", "odd")
            down = info["block_groups"][0]["nodes"][:2]
            for dn_id in down:
                stop_server(by_id[dn_id])
            try:
                _, deg_s = step("encryption degraded GET", get(tde), ["odd"],
                                "encryption_degraded_get", codes=True)
            finally:
                for dn_id in down:
                    restart_server(by_id[dn_id])
            print(f"encryption (c): degraded GET of {odd.size} B with {down} stopped: the "
                  f"decode form on ciphertext, byte-exact in {deg_s:.3f} s = "
                  f"{odd.size / deg_s / 2**30:.3f} GiB/s")
            scm = RemoteScmClient(meta.address, tls=om.tls)
            try:
                ec_ids = {c["id"] for c in scm.list_containers()}
                for cid in sorted(ec_ids):
                    scm.admin("close-container", str(cid))
                wait_for("the containers closed", lambda: all(
                    c["state"] == "CLOSED" and all(r["state"] == "CLOSED"
                                                   for r in c["replicas"])
                    for c in scm.list_containers() if c["id"] in ec_ids), 30)
            finally:
                scm.close()
            t0 = time.perf_counter()
            spare = DatanodeDaemon(root / "dn9", "dn9", meta.address, rack="/rack0",
                                   heartbeat_interval_s=0.5, device=device,
                                   ca_address=meta.enroll_address,
                                   enrollment_secret=secret)
            enroll_s.append(time.perf_counter() - t0)
            spare.start()
            dns.append(spare)
            by_id["dn9"] = spare
            wait_for("the spare enforcing, with the keys",
                     lambda: spare.verifier.enabled and spare.secrets.export_keys(), 30)
            rep = repair_onto_spare(meta, dns, by_id, info["block_groups"][0]["nodes"][2],
                                    device, bpc, "encryption repair",
                                    "over mutual TLS with tokens the datanodes signed")
            out["launches"]["encryption_repair"] = rep["launches"]
            out["repair_mib_s_per_target"] = rep["mib_s_per_target"]
            dns.remove(by_id[info["block_groups"][0]["nodes"][2]])

            # (d) master-key rotation: EDEK versions 0 and 1 both read back
            with om.user_context("root"):
                rot = om.kms_create_key("mk1", rotate=True)
            late = rng.integers(0, 256, 6 * cell + 5, dtype=np.uint8)
            step("encryption PUT after the rotation",
                 lambda _: tde.write_key("late", late), [0], "encryption_rotated_put",
                 codes=True)
            versions = [om.lookup_key("enc", "tde", k)["encryption"]["version"]
                        for k in ("k0", "late")]
            if versions != [0, 1] or rot["versions"] != 2 or not np.array_equal(
                    tde.read_key("late"), late) or not np.array_equal(
                    tde.read_key("k0"), keys["k0"]):
                raise AssertionError(f"rotation: versions {versions}, {rot}")
            print(f"encryption (d): mk1 rotated to {rot['versions']} versions; a key "
                  "of EDEK version 0 and one of version 1 read back byte-exact")

            # (e) GDPR: the secret dies in the delete's apply. The daemon's
            # background pass purges the deleted rows soon after, so every
            # row the applies put into deleted_keys is recorded as written
            store = meta.om.store
            written: list = []
            real_put = store.put

            def spy_put(table, key, value):
                if table == "deleted_keys":
                    written.append(json.loads(json.dumps(value)))
                return real_put(table, key, value)

            store.put = spy_put
            om.create_bucket("enc", "gdpr", rs, gdpr=True)
            gb = oz.get_volume("enc").get_bucket("gdpr")
            subj = rng.integers(0, 256, 6 * cell + 777, dtype=np.uint8)
            step("encryption GDPR PUT", lambda _: gb.write_key("subject", subj), [0],
                 "encryption_gdpr_put", codes=True)
            ginfo = om.lookup_key("enc", "gdpr", "subject")
            gsecret = bytes.fromhex(ginfo["encryption"]["gdpr_secret"])
            if not np.array_equal(gb.read_key("subject"), subj):
                raise AssertionError("GDPR GET: bytes differ")
            gb.delete_key("subject")
            raw, purged, base = [], 0, 0  # (key offset, chunk, bytes) of data units
            for g in om.key_block_groups(ginfo):
                for u, dn_id in enumerate(g.pipeline.nodes[:6]):
                    try:
                        blk = by_id[dn_id].dn.get_block(g.block_id)
                        raw += [(base + ch.offset // cell * 6 * cell + u * cell
                                 + ch.offset % cell, ch,
                                 by_id[dn_id].dn.read_chunk(g.block_id, ch))
                                for ch in blk.chunks]
                    except (StorageError, KeyError):
                        purged += 1
                base += g.length
            rows = [v for v in written
                    if v.get("bucket") == "gdpr" and v.get("name") == "subject"]
            if not rows or any(r.get("encryption") != {"erased": True} for r in rows):
                raise AssertionError(f"GDPR: the deleted row kept its secret: {rows}")
            if not raw:
                raise AssertionError("GDPR: every chunk purged before the raw read")
            for o, ch, data in raw:
                plain_slice = subj[o:o + ch.length]
                if np.array_equal(data, plain_slice) or not np.array_equal(
                        ctr_crypt(data, gsecret, bytes.fromhex(ginfo["encryption"]["iv"]),
                                  o), plain_slice):
                    raise AssertionError(f"GDPR raw chunk {ch.name}: not the ciphertext")
            om.create_bucket("enc", "gfso", rs, layout="FILE_SYSTEM_OPTIMIZED", gdpr=True)
            fb = oz.get_volume("enc").get_bucket("gfso")
            names = [f"f{i}" for i in range(gdpr_files)]
            step("encryption GDPR FSO PUT",
                 lambda n: fb.write_key(f"dir/sub/{n}", subj[:cell + 11]), names,
                 "encryption_gdpr_fso_put", codes=True)
            om.delete_directory("enc", "gfso", "dir", recursive=True)
            try:
                t_reap = wait_for("the directory-deleting pass", lambda: sorted(
                    v.get("file_name") for v in written
                    if v.get("bucket") == "gfso") == names, 30)
            finally:
                store.put = real_put
            frows = [v for v in written if v.get("bucket") == "gfso"]
            if any(r.get("encryption") != {"erased": True} for r in frows):
                raise AssertionError("GDPR FSO: a child kept its secret")
            print(f"encryption (e): GDPR key deleted: its row's secret erased in the "
                  f"apply; {len(raw)} raw chunks still on the datanodes ({purged} units "
                  f"already purged) are ciphertext (only the erased secret decrypts "
                  f"them); an FSO directory of {gdpr_files} GDPR files deleted "
                  f"recursively, every child's secret erased ({t_reap:.3f} s to reap)")

            # (f) the transport's refusals, a revocation, a live renewal
            refused(lambda: RemoteScmClient(meta.address).status(), "UNAVAILABLE",
                    "a client with no certificate")
            refused(lambda: RpcDatanodeClient(dns[0].dn.id, dns[0].address).echo(),
                    "UNAVAILABLE", "a plaintext datanode client")
            refused(lambda: CertificateClient(root / "rogue", "client-rogue").enroll_remote(
                meta.enroll_address, secret="wrong"), "IO_EXCEPTION",
                "a bad enrollment secret")
            g0 = om.key_block_groups(om.lookup_key("enc", "tde", "k0"))[0]
            bare = RpcDatanodeClient(g0.pipeline.nodes[0],
                                     by_id[g0.pipeline.nodes[0]].address, tls=om.tls)
            refused(lambda: bare.get_block(g0.block_id),
                    "BLOCK_TOKEN_VERIFICATION_FAILED", "an untokened read over mTLS")
            bare.close()
            doomed = enrolled(root / "doomed", "client-doomed")
            d_scm = RemoteScmClient(meta.address, tls=doomed)
            d_dn = RpcDatanodeClient(dns[1].dn.id, dns[1].address, tls=doomed)
            admin = RemoteScmClient(meta.address, tls=om.tls)
            try:
                d_scm.status()
                d_dn.echo()
                t_rev = time.perf_counter()
                admin.admin("cert-revoke", str(doomed.serial()))

                def refused_now(fn):
                    try:
                        fn()
                        return False
                    except StorageError as e:
                        if e.code != "CERTIFICATE_REVOKED":
                            raise
                        return True

                wait_for("the metadata server refuses the revoked",
                         lambda: refused_now(d_scm.status), 10, 0.01)
                meta_s = time.perf_counter() - t_rev
                wait_for("a datanode refuses the revoked",
                         lambda: refused_now(d_dn.echo), 30, 0.05)
                dn_s = time.perf_counter() - t_rev
                issued = admin.admin("cert-list")["result"]
            finally:
                d_scm.close()
                d_dn.close()
                admin.close()
            if not any(r["serial"] == doomed.serial() and r["revoked"] for r in issued):
                raise AssertionError("cert-list does not mark the revoked certificate")
            out["revoke_s"] = {"meta": meta_s, "datanode": dn_s}
            # a live renewal of a datanode's certificate under PUTs
            d0 = dns[0]
            old = d0.cert_client.cert.serial_number
            errors: list = []
            stop = threading.Event()
            small = rng.integers(0, 256, 6 * cell, dtype=np.uint8)

            def traffic(i):
                if i == 0:
                    renewals = d0.cert_renewal.renewals
                    d0.cert_client.install(
                        meta.ca.sign_csr(d0.cert_client.make_csr(), valid_days=0),
                        meta.ca.root_pem)
                    d0.tls.reload()
                    d0.cert_renewal.check_once()
                    # the datanode's own renewal thread (a check every second)
                    # may renew the expiring certificate first
                    if d0.cert_renewal.renewals == renewals:
                        errors.append("no renewal")
                    stop.set()
                    return
                j = 0
                while not stop.is_set() or j < n_renew:
                    try:
                        tde.write_key(f"renew/{i}/{j}", small)
                    except Exception as e:  # noqa: BLE001 - the count is the check
                        errors.append(repr(e))
                    j += 1

            step("encryption PUTs across a live renewal", traffic, [0, 1, 2],
                 "encryption_renewal_put", codes=True)
            new = d0.cert_client.cert.serial_number
            probe = RpcDatanodeClient(d0.dn.id, d0.address, tls=om.tls)
            try:
                probe.echo()
                served = probe._ch._idle[0].getpeercert(binary_form=True)
            finally:
                probe.close()
            import ssl

            renewed = ssl.PEM_cert_to_DER_cert(d0.cert_client.cert_path.read_text())
            if errors or new == old or served != renewed:
                raise AssertionError(f"live renewal: {errors[:3]} {old} {new}")
            hs = rpc.METRICS.histogram("tls_handshake")
            n_hs, hs_s = hs.count - hs0[0], hs.total - hs0[1]
            out["handshake_ms"] = 1e3 * hs_s / max(n_hs, 1)
            lanes = {k: sum(d.lane_counts()[k] for d in dns) for k in (
                "native_write_streams", "native_read_streams", "rpc_chunk_calls")}
            if lanes["native_write_streams"] or lanes["native_read_streams"] or \
                    not lanes["rpc_chunk_calls"]:
                raise AssertionError(f"lane counts: {lanes}")
            print(f"encryption (f): no certificate UNAVAILABLE (metadata server and "
                  f"datanode), a bad enrollment secret IO_EXCEPTION, no token "
                  f"BLOCK_TOKEN_VERIFICATION_FAILED; a revoked certificate "
                  f"CERTIFICATE_REVOKED {meta_s:.3f} s after cert-revoke at the metadata "
                  f"server, {dn_s:.3f} s at a datanode (its trust refresh every 1 s); "
                  f"{d0.dn.id}'s certificate renewed live under {2 * n_renew}+ PUTs, no failed "
                  f"call, new handshakes served serial {new}; {n_hs} TLS handshakes, "
                  f"{out['handshake_ms']:.2f} ms each (client side); enrollment "
                  f"{statistics.mean(enroll_s):.3f} s per datanode; lanes {lanes}")
        finally:
            if gw is not None:
                gw.stop()
            for c in (oz, gw_oz):
                if c is not None:
                    c.om.close()
                    c.clients.close()
            for d in dns:
                d.stop()
            meta.stop()
    return out


# ------------------------------------------------------------ SCM admin path
class _Collect(logging.Handler):
    """Holds the port's log records of a phase instead of printing them: a
    phase that drives expected command failures (the shared faults) prints
    their count, and its records only when it fails."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records: list[logging.LogRecord] = []

    def emit(self, record):
        self.records.append(record)

    def dump(self, last: int = 40) -> None:
        fmt = logging.Formatter("%(levelname)s:%(name)s:%(message)s")
        for r in self.records[-last:]:
            print(fmt.format(r), file=sys.stderr)


def scm_admin_path(device, cell: int, bpc: int, seed: int, n_keys: int = 9,
                   key_cells: int = 68, n_writers: int = 4,
                   writer_cells: int = 32, band_cells: int = 16) -> dict:
    """The rest of the SCM (Apache Ozone's feature/Decommission.md,
    feature/Topology.md and `ozone admin containerbalancer`): an
    ScmOmDaemon and 12 DatanodeDaemons on 4 racks with 2 volumes each,
    rs-6-3 at `cell`, CRC32C per `bpc`, a remote OzoneClient reading
    nearest-first from /rack0. `n_keys` keys of `key_cells` cells and odd
    tails are PUT three at a time, each batch's container closed after
    it. (a) A volume
    of the datanode with the most EC containers on it is removed; its
    replicas leave the report, the node stays HEALTHY, and the SCM rebuilds
    the lost units elsewhere by decode: every chunk and its CRCs equal the
    lost one's (MiB/s per target); a PUT after it lands only on the
    node's healthy volume. (b) `admin datanode decommission` (a process)
    under `n_writers` writers of `writer_cells` cells: nothing is allocated
    on the draining node, its units are copied off (drain seconds, bytes
    moved) and equal the originals; the node is stopped and declared dead,
    and every key is read back byte-exact. (c) A node decommissioned and
    stopped at once: the copies planned from it fail (a shared fault,
    counted) until it is declared DEAD, then its units are rebuilt by
    decode, byte-exact. (d) `admin datanode maintenance`: its units are
    copied, `recommission` brings it back and the excess replicas are
    deleted (the repeated deletes that fail are the other shared fault).
    (e) The SCM restarts mid-drain and relearns the drain from its store
    and the node's echo; the node goes DECOMMISSIONED. (f) `admin balancer
    start` with a band of `band_cells` cells over the node capacity (a cut:
    upstream's default is 10%) moves containers from hot to cold nodes
    until the spread is inside the band; every key reads back byte-exact;
    `balancer_status()` survives another SCM restart. (g) `admin datanode
    list`, `pipeline list`, `replicationmanager` and `balancer status` as
    processes. Kernel launches equal the codec service's dispatches in
    every step; a step that rebuilds launched the decode on the card. The
    only datanode commands allowed to fail are those of the two shared
    faults (ROADMAP Queue 3), printed by step and type."""
    from collections import Counter

    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.net.scm_service import RemoteScmClient
    from ozone_tpu_torch.scm.node_manager import NodeOperationalState, NodeState
    from ozone_tpu_torch.scm.replication_manager import (
        DeleteReplicaCommand,
        ReplicateCommand,
    )
    from ozone_tpu_torch.utils import checksum

    rs = f"rs-6-3-{cell // 1024}k"
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    rng = np.random.default_rng(seed + 17)
    keys: dict[str, np.ndarray] = {}
    out: dict = {"launches": {}, "failed": {}}
    stopped: set[str] = set()
    n_dn = 12
    collect = _Collect()
    port_log = logging.getLogger("ozone_tpu_torch")
    old_propagate = port_log.propagate

    def payload(n_cells: int, tail: int) -> np.ndarray:
        return rng.integers(0, 256, n_cells * cell + tail, dtype=np.uint8)

    def admin_cli(*argv) -> tuple[object, float]:
        """An `admin` verb of the port's CLI as a process: its JSON, seconds."""
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ozone_tpu_torch.tools", "admin", *argv,
             "--om", meta.address], capture_output=True, text=True,
            timeout=60, cwd=str(repo), env=env)
        if proc.returncode != 0:
            raise AssertionError(f"admin {' '.join(argv)} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        return json.loads(proc.stdout), time.perf_counter() - t0

    def serving(dn_id: str) -> bool:
        n = meta.scm.nodes.get(dn_id)
        return (n is not None and n.state is NodeState.HEALTHY
                and n.op_state is NodeOperationalState.IN_SERVICE)

    def census() -> dict:
        with meta.scm_service.lock:
            st = meta.scm.replication_status()
            st["open"] = sum(c.state.value != "CLOSED"
                             for c in meta.scm.containers.containers())
        return st

    def settled() -> bool:
        st = census()
        return (st["under_replicated"] == st["over_replicated"] == st["missing"]
                == st["open"] == 0 and not meta.scm.balancer.inflight)

    def close_all(what: str) -> float:
        """Close every open container and wait until the SCM holds every
        index of every container CLOSED on a live node."""
        t0 = time.perf_counter()
        with meta.scm_service.lock:
            open_ids = [c.id for c in meta.scm.containers.containers()
                        if c.state.value == "OPEN"]
        for cid in open_ids:
            scm_client.admin("close-container", cid)
        wait_for(f"{what}: containers closed and settled", settled, 60, poll_s=0.05)
        return time.perf_counter() - t0

    def units_of(dn_id: str, vol=None) -> dict:
        """The EC units a datanode holds (on one volume, if given):
        {(container, index): {block: [(offset, length, CRC words, bytes)]}}."""
        dn = by_id[dn_id].dn
        units = {}
        for c in dn.list_containers():
            if c.replica_index <= 0 or (vol is not None and c.db is not vol.db):
                continue
            units[(c.id, c.replica_index)] = {
                b.block_id: [(ch.offset, ch.length, ch.checksum.checksums,
                              dn.read_chunk(b.block_id, ch).tobytes())
                             for ch in b.chunks]
                for b in dn.list_blocks(c.id)}
        return units

    def home(cid: int, idx: int, exclude: set) -> str | None:
        """A serving node the SCM lists as holding the index CLOSED, and
        whose datanode holds it CLOSED on a healthy volume."""
        with meta.scm_service.lock:
            c = meta.scm.containers.get_or_none(cid)
            held = [dn for dn, r in list(c.replicas.items())
                    if r.replica_index == idx and r.state == "CLOSED"
                    and dn not in exclude and serving(dn)] if c else []
        for dn_id in held:
            dn = by_id[dn_id].dn
            rc = next((x for x in dn.list_containers() if x.id == cid), None)
            if rc is not None and rc.replica_index == idx and \
                    rc.state.value == "CLOSED" and \
                    not any(v.failed and rc.db is v.db for v in dn.volumes):
                return dn_id
        return None

    def check_rehomed(what: str, units: dict, exclude: set, secs: float) -> dict:
        """Every unit now lives on another serving node with equal chunks
        and CRC words (equal to the host CRC32C of the bytes, on the
        native route: the numpy one runs at tens of MB/s); returns bytes
        per target."""
        host = checksum.Checksum(checksum.ChecksumType.CRC32C, bpc)
        per_target: dict[str, int] = {}
        for (cid, idx), blocks in units.items():
            tgt = home(cid, idx, exclude)
            if tgt is None:
                raise AssertionError(f"{what}: container {cid} index {idx} "
                                     "has no new home")
            dn = by_id[tgt].dn
            for bid, chunks in blocks.items():
                got = [(ch.offset, ch.length, ch.checksum.checksums,
                        dn.read_chunk(bid, ch).tobytes())
                       for ch in dn.get_block(bid).chunks]
                if got != chunks:
                    raise AssertionError(f"{what}: {bid} index {idx} on {tgt} "
                                         "differs from the lost unit")
                for _, _, words, data in got:
                    if host.compute(np.frombuffer(data, np.uint8)).checksums \
                            != words:
                        raise AssertionError(f"{what}: CRCs of {bid} differ "
                                             "from the host CRC32C")
                    per_target[tgt] = per_target.get(tgt, 0) + len(data)
        rates = ", ".join(f"{t} {n} B = {n / secs / MIB:.1f} MiB/s"
                          for t, n in sorted(per_target.items()))
        out.setdefault("mib_s_per_target", {})[what] = {
            t: n / secs / MIB for t, n in per_target.items()}
        return per_target, rates

    def begin() -> dict:
        fused_kernel.launches.reset()
        return {"svc": service_counts(),
                "errors": {id(d): len(d.command_errors) for d in dns}}

    def end(what: str, key: str, mark: dict, decode: bool = False) -> int:
        """Launches equal dispatches (a decode step launched on the card);
        the step's failed commands are the shared faults' only."""
        launches = fused_kernel.launches.count
        check_launches_equal(what, device, launches, service_delta(mark["svc"]))
        if decode and device.type == "cuda" and launches <= 0:
            raise AssertionError(f"{what}: no decode launched")
        out["launches"][key] = launches
        failed = Counter()
        for d in dns:
            for cmd, e in d.command_errors[mark["errors"].get(id(d), 0):]:
                code = getattr(e, "code", type(e).__name__)
                if isinstance(cmd, DeleteReplicaCommand) and \
                        code == "CONTAINER_NOT_FOUND":
                    failed["DeleteReplicaCommand (excess delete again)"] += 1
                elif isinstance(cmd, ReplicateCommand) and cmd.source in stopped:
                    failed["ReplicateCommand (source stopped)"] += 1
                else:
                    raise AssertionError(f"{what}: {d.dn.id} command {cmd!r} "
                                         f"failed: {e!r}")
        out["failed"][what] = dict(failed)
        return launches

    def get_all(what: str, key: str) -> str:
        """Every key GET through the OzoneClient, byte-exact."""
        reloc0 = meta.om.metrics.counter("units_relocated").value
        mark = begin()
        t0 = time.perf_counter()
        bucket = oz.get_volume("adm").get_bucket("b")

        def get(name):
            if not np.array_equal(bucket.read_key(name), keys[name]):
                raise AssertionError(f"{what}: {name} differs")

        concurrent(get, sorted(keys))
        secs = time.perf_counter() - t0
        launches = end(what, key, mark)
        total = sum(v.size for v in keys.values())
        return (f"{len(keys)} keys, {total} B byte-exact through the OzoneClient "
                f"GET in {secs:.3f} s = {total / secs / 2**30:.3f} GiB/s; decode "
                f"launches {launches}; units the lookups pointed at their current "
                f"homes {meta.om.metrics.counter('units_relocated').value - reloc0}")

    def declare_dead(dn_id: str) -> None:
        with meta.scm_service.lock:
            meta.scm.nodes.get(dn_id).last_heartbeat = -1e9
            meta.scm.nodes.check_liveness()
        if meta.scm.nodes.get(dn_id).state is not NodeState.DEAD:
            raise AssertionError(f"{dn_id} not DEAD")

    def restart_scm(what: str) -> float:
        """Stop the metadata daemon and start it again on its port and
        store; safemode holds until every live datanode registered (with
        its report)."""
        nonlocal meta
        t0 = time.perf_counter()
        port = meta.server.port
        meta.stop()
        meta = ScmOmDaemon(root / "om.db", port=port, **meta_kw,
                           min_datanodes=n_dn - len(stopped))
        meta.start()
        wait_for(f"{what}: every live datanode registered", lambda: all(
            meta.scm.nodes.get(d.dn.id) is not None for d in dns
            if d.dn.id not in stopped), 30, poll_s=0.05)
        return time.perf_counter() - t0

    def revive(dn_id: str) -> None:
        """Start a stopped datanode again on its root."""
        i = next(i for i, d in enumerate(dns) if d.dn.id == dn_id)
        d = DatanodeDaemon(root / dn_id, dn_id, meta.address,
                           rack=f"/rack{int(dn_id[2:]) % 4}",
                           heartbeat_interval_s=0.2, device=device, num_volumes=2)
        d.start()
        dns[i] = d
        by_id[dn_id] = d
        stopped.discard(dn_id)

    def used_mib() -> dict:
        return {n.dn_id: n.used_bytes / MIB for n in meta.scm.nodes.nodes()
                if serving(n.dn_id)}

    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-scm-") as tmp:
        root = Path(tmp)
        port_log.addHandler(collect)
        port_log.propagate = False
        # four blocks per container: a batch of up to four concurrent
        # writers starts on a fresh container (the open ones are closed
        # between batches) and never sees it closed under a block in
        # flight (the SCM closes a full container at the next allocation)
        meta_kw = dict(block_size=16 * cell, container_size=64 * cell,
                       stale_after_s=30.0, dead_after_s=60.0,
                       background_interval_s=0.2, placement_seed=seed,
                       device=device)
        meta = ScmOmDaemon(root / "om.db", **meta_kw)
        meta.start()
        dns: list = []
        by_id: dict = {}
        clients = DatanodeClientFactory()
        clients.location = "/rack0"  # reads go nearest-first from here
        scm_client = RemoteScmClient(meta.address)
        oz = None
        try:
            for i in range(n_dn):
                d = DatanodeDaemon(root / f"dn{i}", f"dn{i}", meta.address,
                                   rack=f"/rack{i % 4}", heartbeat_interval_s=0.2,
                                   device=device, num_volumes=2)
                d.start()
                dns.append(d)
                by_id[d.dn.id] = d
            wait_for("12 datanodes registered",
                     lambda: len(meta.scm.nodes.nodes()) == n_dn, 30)
            oz = OzoneClient(RemoteOmClient(meta.address, clients=clients),
                             clients, device=device)
            bucket = oz.create_volume("adm").create_bucket("b", replication=rs)

            # ---- setup: keys PUT two at a time, containers closed
            for i in range(n_keys):
                keys[f"k{i}"] = payload(key_cells, (i * 12345) % cell)
            mark = begin()
            t0 = time.perf_counter()
            names = sorted(keys)
            close_s = 0.0
            for batch in (names[i:i + 3] for i in range(0, len(names), 3)):
                concurrent(lambda n: bucket.write_key(n, keys[n]), batch)
                close_s = close_all("setup")
            put_s = time.perf_counter() - t0
            end("setup PUT", "scm_admin_put", mark)
            total = sum(v.size for v in keys.values())
            print(f"scm_admin setup: {n_dn} datanodes on 4 racks, 2 volumes each; "
                  f"{n_keys} keys, {total} B PUT in {put_s:.3f} s = "
                  f"{total / put_s / 2**30:.3f} GiB/s, three at a time, each batch's "
                  f"container closed after it; {len(meta.scm.containers.containers())} "
                  f"containers, the last closed and settled {close_s:.2f} s after its "
                  "PUT")

            # ---- (a) a failed volume
            def on_vol0(d):
                return sum(c.replica_index > 0 and c.db is d.dn.volumes[0].db
                           for c in d.dn.list_containers())

            va = max(dns, key=on_vol0)
            vol = va.dn.volumes[0]
            lost = units_of(va.dn.id, vol)
            mark = begin()
            t0 = time.perf_counter()
            shutil.rmtree(vol.root)
            if va.dn.check_volumes() != [str(vol.root)]:
                raise AssertionError("(a): the volume checker missed the failure")
            # the node itself may take a unit back, on its healthy volume
            wait_for("(a) rebuild", lambda: all(
                home(cid, idx, set()) for cid, idx in lost), 60, poll_s=0.05)
            secs = time.perf_counter() - t0
            end("(a) failed volume", "scm_admin_failed_volume", mark, decode=True)
            per, rates = check_rehomed("(a)", lost, set(), secs)
            node = meta.scm.nodes.get(va.dn.id)
            if node.state is not NodeState.HEALTHY or node.healthy_volumes != 1:
                raise AssertionError(f"(a): {va.dn.id} {node.state} with "
                                     f"{node.healthy_volumes} healthy volumes")
            print(f"scm_admin (a) failed volume: {va.dn.id} lost {vol.root.name}; "
                  f"{sum(len(b) for b in lost.values())} blocks "
                  f"({sum(per.values())} B) of {len(lost)} units rebuilt by decode "
                  f"in {secs:.3f} s from the report delta: {rates} per target; "
                  "every chunk and its CRCs equal the lost one's")
            before = {c.id for c in va.dn.list_containers()}
            mark = begin()
            n_put = 0
            while n_put < 3:  # until a new container lands on the node
                n_put += 1
                keys[f"a{n_put}"] = payload(6, 777 * n_put)
                bucket.write_key(f"a{n_put}", keys[f"a{n_put}"])
                if {c.id for c in va.dn.list_containers()} - before:
                    break
                close_all("(a) PUT")
            end("(a) PUT", "scm_admin_failed_volume_put", mark)
            new = [c for c in va.dn.list_containers() if c.id not in before]
            if any(c.db is not va.dn.volumes[1].db for c in new):
                raise AssertionError("(a): a container landed on the failed volume")
            close_all("(a)")
            print(f"scm_admin (a): {va.dn.id} stays HEALTHY with 1 healthy volume; "
                  f"{len(new)} new container(s) on it after {n_put} PUT(s), all on "
                  "its healthy volume")

            # ---- (b) decommission under writers
            def ec_units(d):
                return sum(c.replica_index > 0 for c in d.dn.list_containers())

            vb = max((d for d in dns if d is not va), key=ec_units)
            moved = units_of(vb.dn.id)
            moved_b = sum(len(x[3]) for blocks in moved.values()
                          for chunks in blocks.values() for x in chunks)
            wkeys = {f"w{i}": payload(writer_cells, 4321 * i) for i in range(n_writers)}
            keys.update(wkeys)
            mark = begin()
            t0 = time.perf_counter()
            ans, cli_s = admin_cli("datanode", "decommission", vb.dn.id)
            if ans["op_state"] != "DECOMMISSIONING":
                raise AssertionError(f"(b): {ans}")
            tw = time.perf_counter()
            concurrent(lambda n: bucket.write_key(n, wkeys[n]), sorted(wkeys))
            write_s = time.perf_counter() - tw
            wait_for("(b) drain", lambda: meta.scm.nodes.get(vb.dn.id).op_state
                     is NodeOperationalState.DECOMMISSIONED, 60, poll_s=0.05)
            drain_s = time.perf_counter() - t0
            end("(b) decommission", "scm_admin_decommission_put", mark)
            per, _ = check_rehomed("(b)", moved, {vb.dn.id}, drain_s)
            for n in wkeys:
                info = oz.om.lookup_key("adm", "b", n)
                if any(vb.dn.id in g["nodes"] for g in info["block_groups"]):
                    raise AssertionError(f"(b): {n} allocated on the draining node")
            wb = sum(v.size for v in wkeys.values())
            print(f"scm_admin (b): `admin datanode decommission {vb.dn.id}` "
                  f"({cli_s:.2f} s, a process); DECOMMISSIONING -> DECOMMISSIONED in "
                  f"{drain_s:.3f} s, {len(moved)} units ({moved_b} B) copied off it "
                  f"byte-exact, none rebuilt by decode (the reference copies); "
                  f"{n_writers} writers PUT {wb} B in {write_s:.3f} s = "
                  f"{wb / write_s / 2**30:.3f} GiB/s meanwhile, none allocated on it")
            by_id[vb.dn.id].stop()
            stopped.add(vb.dn.id)
            declare_dead(vb.dn.id)
            close_all("(b)")
            print(f"scm_admin (b) GET with {vb.dn.id} stopped and dead: "
                  + get_all("(b) GET", "scm_admin_get_b"))

            # ---- (c) a node dies mid-drain
            vc = max((d for d in dns if d.dn.id not in stopped and d is not va),
                     key=ec_units)
            lost = units_of(vc.dn.id)
            mark = begin()
            scm_client.admin("decommission", vc.dn.id)
            vc.stop()
            stopped.add(vc.dn.id)
            t_stop = time.perf_counter()
            # the copies planned from it fail, and nothing plans them again
            # while it is only silent (a shared fault)
            time.sleep(0.5)
            declare_dead(vc.dn.id)
            t0 = time.perf_counter()
            wait_for("(c) rebuild", lambda: all(
                home(cid, idx, {vc.dn.id}) for cid, idx in lost), 60, poll_s=0.05)
            secs = time.perf_counter() - t0
            wait_for("(c) DECOMMISSIONED", lambda: meta.scm.nodes.get(vc.dn.id).op_state
                     is NodeOperationalState.DECOMMISSIONED, 30, poll_s=0.05)
            close_all("(c)")
            end("(c) dead mid-drain", "scm_admin_dead_mid_drain", mark, decode=True)
            per, rates = check_rehomed("(c)", lost, {vc.dn.id}, secs)
            print(f"scm_admin (c): {vc.dn.id} decommissioned and stopped at once, "
                  f"declared DEAD {t0 - t_stop:.2f} s later: "
                  f"{sum(len(b) for b in lost.values())} blocks ({sum(per.values())} B) "
                  f"of {len(lost)} units rebuilt by decode in {secs:.3f} s: {rates} per "
                  "target; every chunk and its CRCs equal the lost one's; "
                  f"DECOMMISSIONED; failed commands {out['failed']['(c) dead mid-drain']}")

            # ---- (d) maintenance, recommission, the excess deleted
            live = [d for d in dns if d.dn.id not in stopped and d is not va]
            vd = max(live, key=ec_units)
            held = units_of(vd.dn.id)
            mark = begin()
            ans, cli_m = admin_cli("datanode", "maintenance", vd.dn.id)
            t0 = time.perf_counter()
            wait_for("(d) maintenance copies", lambda: all(
                home(cid, idx, {vd.dn.id}) for cid, idx in held), 60, poll_s=0.05)
            copy_s = time.perf_counter() - t0
            keys["d1"] = payload(6, 99)
            bucket.write_key("d1", keys["d1"])
            if any(vd.dn.id in g["nodes"] for g in
                   oz.om.lookup_key("adm", "b", "d1")["block_groups"]):
                raise AssertionError("(d): allocated on the node in maintenance")
            per, _ = check_rehomed("(d)", held, {vd.dn.id}, copy_s)
            ans2, cli_r = admin_cli("datanode", "recommission", vd.dn.id)
            t1 = time.perf_counter()
            close_all("(d)")
            trim_s = time.perf_counter() - t1
            end("(d) maintenance", "scm_admin_maintenance", mark)
            print(f"scm_admin (d): `admin datanode maintenance {vd.dn.id}` "
                  f"({cli_m:.2f} s) -> {ans['op_state']}: its {len(held)} units "
                  f"({sum(per.values())} B) copied byte-exact in {copy_s:.3f} s, a PUT "
                  f"meanwhile not on it; `recommission` ({cli_r:.2f} s) -> "
                  f"{ans2['op_state']}, the excess replicas deleted and settled in "
                  f"{trim_s:.3f} s; failed commands {out['failed']['(d) maintenance']}")

            # ---- (e) the SCM restarts mid-drain
            live = [d for d in dns if d.dn.id not in stopped and d not in (va, vd)]
            ve = max(live, key=ec_units)
            mark = begin()
            scm_client.admin("decommission", ve.dn.id)
            wait_for("(e) op state persisted on the node",
                     lambda: ve._op_state == "DECOMMISSIONING", 10, poll_s=0.02)
            echo = ve._op_state
            t0 = time.perf_counter()
            up_s = restart_scm("(e)")
            seeded = dict(meta.scm.nodes._seeded_op)
            if seeded.get(ve.dn.id) != "DECOMMISSIONING" or \
                    meta.scm.nodes.get(ve.dn.id).op_state \
                    is not NodeOperationalState.DECOMMISSIONING:
                raise AssertionError(f"(e): the restarted SCM lost the drain: {seeded}")
            wait_for("(e) DECOMMISSIONED", lambda: meta.scm.nodes.get(ve.dn.id).op_state
                     is NodeOperationalState.DECOMMISSIONED, 60, poll_s=0.05)
            done_s = time.perf_counter() - t0
            close_all("(e)")
            end("(e) SCM restart", "scm_admin_scm_restart", mark)
            print(f"scm_admin (e): the SCM restarted mid-drain of {ve.dn.id} (up with "
                  f"every live datanode registered in {up_s:.3f} s); its store seeds "
                  f"{seeded}, the node echoes {echo} at its register; "
                  f"DECOMMISSIONED {done_s:.3f} s after the restart began")

            # ---- (f) the balancer, with the dead node back and both
            # decommissioned live nodes recommissioned: its stale replicas
            # and the drained node's copies go as excess, so the balancer
            # has cold nodes to fill
            mark = begin()
            t0 = time.perf_counter()
            revive(vc.dn.id)
            wait_for("(f) the dead node registered again",
                     lambda: meta.scm.nodes.get(vc.dn.id) is not None, 30, poll_s=0.05)
            for n in (vc.dn.id, ve.dn.id):
                scm_client.admin("recommission", n)
            close_all("(f) recommission")
            back_s = time.perf_counter() - t0
            end("(f) recommission", "scm_admin_recommission", mark)
            print(f"scm_admin (f): {vc.dn.id} restarted, {vc.dn.id} and {ve.dn.id} "
                  f"recommissioned: their excess replicas deleted and settled in "
                  f"{back_s:.3f} s; failed commands "
                  f"{out['failed']['(f) recommission']}")
            cap = meta.scm.nodes.get(va.dn.id).capacity_bytes
            threshold = band_cells * cell / cap
            u0 = used_mib()
            mark = begin()
            t0 = time.perf_counter()
            _, cli_b = admin_cli("balancer", "start", "--threshold", repr(threshold),
                                 "--max-moves", "5", "--max-size", str(10 * 2**30))

            def balanced() -> bool:
                # an iteration that found nothing to move, none in flight
                return (meta.scm.balancer.status.iterations > 0
                        and not meta.scm.balancer.inflight
                        and not meta.scm.balancer.status.last_iteration_moves)

            wait_for("(f) the balancer", balanced, 60, poll_s=0.05)
            bal_s = time.perf_counter() - t0
            st, cli_s2 = admin_cli("balancer", "stop")
            close_all("(f)")
            end("(f) balancer", "scm_admin_balancer", mark)
            u1 = used_mib()
            spread = (max(u0.values()) - min(u0.values()),
                      max(u1.values()) - min(u1.values()))
            band_mib = band_cells * cell / MIB
            if spread[0] > 2 * band_mib and (st["moves_scheduled"] == 0
                                             or spread[1] >= spread[0]):
                raise AssertionError(f"(f): {st['moves_scheduled']} moves, spread "
                                     f"{spread[0]:.1f} -> {spread[1]:.1f} MiB")
            out["balancer"] = {"moves": st["moves_scheduled"], "seconds": bal_s,
                               "spread_mib": spread, "iterations": st["iterations"]}
            print(f"scm_admin (f): `admin balancer start --threshold {threshold:.4g} "
                  f"--max-moves 5 --max-size {10 * 2**30}` ({cli_b:.2f} s; a band of "
                  f"{band_cells * cell} B over {cap} B per node): {st['iterations']} "
                  f"iterations, "
                  f"{st['moves_scheduled']} moves ({st['bytes_scheduled']} B by the "
                  f"SCM's container sizes) done in {bal_s:.3f} s; used spread "
                  f"{spread[0]:.1f} -> {spread[1]:.1f} MiB over {len(u1)} serving nodes "
                  f"({min(u0.values()):.1f}-{max(u0.values()):.1f} -> "
                  f"{min(u1.values()):.1f}-{max(u1.values()):.1f}); failed commands "
                  f"{out['failed']['(f) balancer']}")
            print("scm_admin (f) GET after the balancer: "
                  + get_all("(f) GET", "scm_admin_get_f"))
            mark = begin()
            up_s = restart_scm("(f) restart")
            st2 = meta.scm.balancer_status()
            if st2 != st:
                raise AssertionError(f"(f): balancer_status {st} -> {st2} across a restart")
            close_all("(f) restart")
            end("(f) restart", "scm_admin_balancer_restart", mark)
            print(f"scm_admin (f): balancer_status() survives an SCM restart "
                  f"({up_s:.3f} s): {st2}")

            # ---- (g) the read verbs as processes, at once
            t0 = time.perf_counter()
            answers = concurrent(lambda a: admin_cli(*a), [
                ("datanode", "list"), ("pipeline", "list"),
                ("replicationmanager",), ("balancer", "status")])
            g_s = time.perf_counter() - t0
            ops = Counter(n["op_state"] for n in answers[0][0])
            rm_census = answers[2][0]
            if rm_census["under_replicated"] or rm_census["missing"] or \
                    answers[3][0] != st:
                raise AssertionError(f"(g): {rm_census}, {answers[3][0]}")
            print(f"scm_admin (g): `admin datanode list` {dict(ops)}, `pipeline list` "
                  f"{len(answers[1][0]['pipelines'])} open, `replicationmanager` "
                  f"{rm_census}, `balancer status` equal, four processes in "
                  f"{g_s:.2f} s ({', '.join(f'{a[1]:.2f}' for a in answers)} s each); "
                  "`datanode decommission|maintenance|recommission` and `balancer "
                  "start|stop` ran as processes in (b), (d) and (f)")
            print(f"scm_admin: datanode commands failed by step and type "
                  f"{json.dumps(out['failed'])} (the shared faults of ROADMAP Queue 3 "
                  f"only); {len(collect.records)} warning log records held back")
        except BaseException:
            collect.dump()
            raise
        finally:
            port_log.removeHandler(collect)
            port_log.propagate = old_propagate
            scm_client.close()
            if oz is not None:
                oz.om.close()
            clients.close()
            for d in dns:
                if d.dn.id not in stopped:
                    d.stop()
            meta.stop()
    return out


def snapshot_path(device, cell: int, bpc: int, seed: int, n_obs: int = 6,
                  obs_cells: int = 64, n_fso: int = 4, fso_cells: int = 16,
                  n_extra: int = 8, n_pairs: int = 3) -> dict:
    """Bucket snapshots (Apache Ozone's feature/Snapshot.md: bucket
    snapshots, `.snapshot/` reads, snapdiff) on an ScmOmDaemon and 10
    DatanodeDaemons (9 and a spare), rs-6-3 at `cell`, CRC32C per `bpc`,
    through a remote OzoneClient. An OBS bucket holds `n_obs` keys of
    `obs_cells` cells and odd tails, an FSO bucket `n_fso` files of
    `fso_cells` cells under /d/e/. (a) Snapshot s1 of each (create ms with
    the bucket full, nothing copied), then `n_extra` more of the OBS
    bucket (create ms with them). (b) Two keys overwritten, two deleted,
    one renamed, one added; /d renamed to /d2 and one file deleted; then
    `n_pairs` pairs of PUTs of `obs_cells` cells, alternating in order,
    into the snapshotted bucket and one without snapshots (GiB/s of each).
    (c) Snapshot s2; every key of s1 and s2 GET through `.snapshot/`,
    byte-exact against the source bytes kept. (d) A datanode holding data
    units of the deleted and overwritten keys stopped: their `.snapshot/s1/`
    GETs decode on the card, byte-exact. (e) The s1 -> s2 diff of each
    bucket, synchronous and as a paged job, equal to the expected
    adds, deletes, modifies and renames (the FSO directory rename's files
    as renames), and which route answered (the journal or the full
    listing). (f) The key-deleting service while snapshots exist: every
    chunk file of the deleted and overwritten keys stays on every
    datanode; then every snapshot deleted, newest first (the overlays
    merge down), and the seconds from the last delete to the last chunk
    file gone. (g) A bucket quota of its usage plus one cell, set by `sh
    bucket setquota` as a process: a PUT past it refused with
    QUOTA_EXCEEDED, changing nothing; `repair_quota` gives every bucket's
    usage back unchanged; HttpFS CREATESNAPSHOT, GETSNAPSHOTDIFF and
    DELETESNAPSHOT answer 200; `sh snapshot create|list|diff|delete` as
    processes. Launches equal the codec service's dispatches in every
    step."""
    import urllib.error
    import urllib.request

    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.gateway.httpfs import HttpFSGateway
    from ozone_tpu_torch.om.requests import OMError
    from ozone_tpu_torch.storage.ids import BlockID, StorageError

    rs = f"rs-6-3-{cell // 1024}k"
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    rng = np.random.default_rng(seed + 18)
    gib = float(1 << 30)
    out: dict = {"launches": {}}

    def payload(n_cells: int, tail: int) -> np.ndarray:
        return rng.integers(0, 256, n_cells * cell + tail, dtype=np.uint8)

    def begin() -> dict:
        fused_kernel.launches.reset()
        return service_counts()

    def end(what: str, key: str, mark: dict, decode: bool = False) -> int:
        launches = fused_kernel.launches.count
        check_launches_equal(what, device, launches, service_delta(mark))
        if decode and device.type == "cuda" and launches <= 0:
            raise AssertionError(f"{what}: no decode launched")
        out["launches"][key] = out["launches"].get(key, 0) + launches
        return launches

    def sh(*argv) -> str:
        """A `sh` verb of the port's CLI as a process: its output."""
        proc = subprocess.run(
            [sys.executable, "-m", "ozone_tpu_torch.tools", "sh", *argv,
             "--om", meta.address], capture_output=True, text=True,
            timeout=60, cwd=str(repo), env=env)
        if proc.returncode != 0:
            raise AssertionError(f"sh {' '.join(argv)} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        return proc.stdout

    def code(fn) -> str | None:
        try:
            fn()
        except (OMError, StorageError) as e:
            return e.code
        return None

    def read_all(what: str, reads: dict) -> tuple[int, float]:
        """Every (bucket, path) GET, concurrently, byte-exact against its
        bytes; the bytes and seconds."""
        t0 = time.perf_counter()

        def get(item):
            (bucket, path), data = item
            if not np.array_equal(bucket.read_key(path), data):
                raise AssertionError(f"snapshot {what}: {path} differs")

        concurrent(get, list(reads.items()))
        return sum(v.size for v in reads.values()), time.perf_counter() - t0

    with daemon_cluster(device, 10, cell, seed, "snap") as (meta, dns, oz):
        om = oz.om
        by_id = {d.dn.id: d for d in dns}
        vol = oz.create_volume("snapv")
        obs = vol.create_bucket("obs", replication=rs)
        om.create_bucket("snapv", "fso", rs, "FILE_SYSTEM_OPTIMIZED")
        fsb = vol.get_bucket("fso")
        plain = vol.create_bucket("plain", replication=rs)
        src = {f"k{i}": payload(obs_cells, 1000 * i + 7) for i in range(n_obs)}
        fsrc = {f"d/e/f{i}": payload(fso_cells, 13 * i + 1) for i in range(n_fso)}
        mark = begin()
        t0 = time.perf_counter()
        concurrent(lambda kv: obs.write_key(*kv), list(src.items()))
        concurrent(lambda kv: fsb.write_key(*kv), list(fsrc.items()))
        secs = time.perf_counter() - t0
        launches = end("snapshot setup PUT", "snapshot_setup_put", mark)
        total = sum(v.size for v in src.values()) + sum(v.size for v in fsrc.values())
        print(f"snapshot setup: {n_obs} OBS keys and {n_fso} FSO files, {total} B "
              f"PUT in {secs:.3f} s = {total / secs / gib:.3f} GiB/s ({launches} "
              "launches)")

        # ---- (a) snapshots of full buckets: chain rows only
        t0 = time.perf_counter()
        s1 = om.create_snapshot("snapv", "obs", "s1")
        obs_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        om.create_snapshot("snapv", "fso", "s1")
        fso_ms = 1e3 * (time.perf_counter() - t0)
        extra_ms = []
        for j in range(n_extra):
            t0 = time.perf_counter()
            om.create_snapshot("snapv", "obs", f"x{j}")
            extra_ms.append(1e3 * (time.perf_counter() - t0))
        copied = [k for k, _ in meta.om.store.iterate("keys", "/.snapshot/")]
        if copied or not s1["cow"]:
            raise AssertionError(f"snapshot (a): create copied {len(copied)} rows")
        out["create_ms"] = {"obs_s1": obs_ms, "fso_s1": fso_ms,
                            "obs_with_snapshots": extra_ms}
        print(f"snapshot (a): create s1 of the full OBS bucket {obs_ms:.2f} ms, of "
              f"the FSO bucket {fso_ms:.2f} ms, no row copied; {n_extra} more of "
              f"the OBS bucket {extra_ms[0]:.2f} ms (1 before it) ... "
              f"{extra_ms[-1]:.2f} ms ({n_extra} before it)")

        # ---- (b) mutations after the snapshot, and the paired PUT series
        v1 = {"obs": dict(src), "fso": dict(fsrc)}
        live, flive = dict(src), dict(fsrc)
        over, gone = ["k0", "k1"], ["k2", "k3"]
        mark = begin()
        for k in over:
            live[k] = payload(obs_cells, 4242)
            obs.write_key(k, live[k])
        for k in gone:
            obs.delete_key(k)
            live.pop(k)
        obs.rename_key("k4", "k4-renamed")
        live["k4-renamed"] = live.pop("k4")
        live["k-new"] = payload(obs_cells, 99)
        obs.write_key("k-new", live["k-new"])
        fsb.rename_key("d", "d2")
        flive = {"d2" + k[1:]: v for k, v in flive.items()}
        fsb.delete_key(f"d2/e/f{n_fso - 1}")
        flive.pop(f"d2/e/f{n_fso - 1}")
        series = {"obs": [], "plain": []}
        for i in range(n_pairs):
            data = payload(obs_cells, 0)
            for name in (("obs", "plain") if i % 2 == 0 else ("plain", "obs")):
                t0 = time.perf_counter()
                (obs if name == "obs" else plain).write_key(f"pair{i}", data)
                series[name].append(data.size / (time.perf_counter() - t0) / gib)
            live[f"pair{i}"] = data
        launches = end("snapshot (b) PUTs", "snapshot_cow_put", mark)
        out["put_gib_s"] = {k: statistics.mean(v) for k, v in series.items()}
        print(f"snapshot (b): 2 overwrites, 2 deletes, a rename and an add in the "
              f"OBS bucket, /d -> /d2 and a delete in the FSO bucket; {n_pairs} "
              f"pairs of {obs_cells} MiB PUTs, alternating: into the snapshotted "
              f"bucket {[round(x, 4) for x in series['obs']]} GiB/s (mean "
              f"{out['put_gib_s']['obs']:.4f}), into one without snapshots "
              f"{[round(x, 4) for x in series['plain']]} (mean "
              f"{out['put_gib_s']['plain']:.4f}), ratio "
              f"{out['put_gib_s']['obs'] / out['put_gib_s']['plain']:.3f}; "
              f"{launches} launches")

        # ---- (c) s2, and every key of both snapshots through .snapshot/
        om.create_snapshot("snapv", "obs", "s2")
        om.create_snapshot("snapv", "fso", "s2")
        v2 = {"obs": dict(live), "fso": dict(flive)}
        reads = {}
        for snap, vers in (("s1", v1), ("s2", v2)):
            for bname, bucket in (("obs", obs), ("fso", fsb)):
                listed = sorted(r["name"] for r in om.snapshot_keys("snapv", bname, snap))
                if listed != sorted(vers[bname]):
                    raise AssertionError(f"snapshot (c): {bname}@{snap} lists {listed}")
                for name, data in vers[bname].items():
                    reads[(bucket, f".snapshot/{snap}/{name}")] = data
        mark = begin()
        total, secs = read_all("(c)", reads)
        launches = end("snapshot (c) GETs", "snapshot_get", mark)
        out["get_gib_s"] = total / secs / gib
        print(f"snapshot (c): {len(reads)} keys of s1 and s2, {total} B, GET through "
              f".snapshot/ byte-exact in {secs:.3f} s = {out['get_gib_s']:.3f} GiB/s "
              f"({launches} launches)")

        # ---- (d) degraded .snapshot/ GETs: a data-unit holder stopped
        infos = {k: om.snapshot_lookup_key("snapv", "obs", "s1", k) for k in over + gone}
        holds: dict[str, int] = {}
        for info in infos.values():
            for dn_id in {n for g in info["block_groups"] for n in g["nodes"][:6]}:
                holds[dn_id] = holds.get(dn_id, 0) + 1
        victim = max(sorted(holds), key=lambda n: holds[n])
        stop_server(by_id[victim])
        try:
            mark = begin()
            nbytes, secs = read_all("(d)", {(obs, f".snapshot/s1/{k}"): v1["obs"][k]
                                            for k in over + gone})
            launches = end("snapshot (d) degraded GETs", "snapshot_degraded_get", mark,
                           decode=True)
        finally:
            restart_server(by_id[victim])
        out["degraded_gib_s"] = nbytes / secs / gib
        print(f"snapshot (d): {victim} (a data unit of {holds[victim]} of the 4 "
              f"keys) stopped; the deleted and overwritten keys' {nbytes} B GET "
              f"through .snapshot/s1/ byte-exact in {secs:.3f} s = "
              f"{out['degraded_gib_s']:.3f} GiB/s, {launches} decode launches")

        # ---- (e) the s1 -> s2 diffs, synchronous and paged
        fkeys = [f"d/e/f{i}" for i in range(n_fso)]
        want = {
            "obs": {"added": sorted(["k-new"] + [f"pair{i}" for i in range(n_pairs)]),
                    "deleted": gone, "modified": over,
                    "renamed": [["k4", "k4-renamed"]]},
            "fso": {"added": [], "deleted": [fkeys[-1]], "modified": [],
                    "renamed": [[k, "d2" + k[1:]] for k in fkeys[:-1]]},
        }
        out["diff_s"] = {}
        for bname, exp in want.items():
            t0 = time.perf_counter()
            d = om.snapshot_diff("snapv", bname, "s1", "s2")
            sync_s = time.perf_counter() - t0
            got = {k: d[k] for k in exp}
            if got != exp:
                raise AssertionError(f"snapshot (e): {bname} diff {got} != {exp}")
            t0 = time.perf_counter()
            job = om.snapshot_diff_submit("snapv", bname, "s1", "s2")
            wait_for(f"snapshot (e): {bname} diff job", lambda: (om.snapshot_diff_submit(
                "snapv", bname, "s1", "s2")["status"] != "IN_PROGRESS"), 60, 0.02)
            entries, token = [], ""
            while True:
                page = om.snapshot_diff_page(job["job_id"], token, 2)
                entries += page["entries"]
                token = page["next_token"]
                if not token:
                    break
            job_s = time.perf_counter() - t0
            exp_entries = ([{"op": "RENAME", "key": a, "target": b}
                            for a, b in exp["renamed"]]
                           + [{"op": "DELETE", "key": k} for k in exp["deleted"]]
                           + [{"op": "MODIFY", "key": k} for k in exp["modified"]]
                           + [{"op": "ADD", "key": k} for k in exp["added"]])
            if page["status"] != "DONE" or entries != exp_entries:
                raise AssertionError(f"snapshot (e): {bname} paged diff {entries}")
            out["diff_s"][bname] = {"sync": sync_s, "job": job_s, "mode": d["mode"]}
            examined = (f", {d['keys_examined']} keys examined"
                        if "keys_examined" in d else "")
            print(f"snapshot (e): {bname} s1 -> s2 diff {sync_s:.4f} s synchronous "
                  f"(answered by: {d['mode']}{examined}), {job_s:.4f} s as a job "
                  f"paged by 2 ({len(entries)} entries), both equal to the expected "
                  "set")

        # ---- (f) the deferred purge
        old = [om.snapshot_lookup_key("snapv", "obs", "s1", k) for k in over + gone]
        old.append(om.snapshot_lookup_key("snapv", "fso", "s1", fkeys[-1]))
        # every unit's chunk file, but a data unit past a short group's bytes
        # (the writer makes no block for it)
        blocks = [(dn_id, BlockID(int(g["container_id"]), int(g["local_id"])))
                  for info in old for g in info["block_groups"]
                  for u, dn_id in enumerate(g["nodes"])
                  if u >= 6 or int(g["length"]) > u * cell]

        def present() -> list:
            left = []
            for dn_id, bid in blocks:
                try:
                    path = by_id[dn_id].dn.containers.get(
                        bid.container_id).chunks.block_path(bid)
                except (KeyError, StorageError):
                    continue
                if path.exists():
                    left.append((dn_id, bid))
            return left

        missing = set(blocks) - set(present())
        if missing:
            raise AssertionError("snapshot (f): chunk files missing before the "
                                 f"purge: {sorted(missing, key=str)[:6]}")
        with meta.scm_service.lock:
            purged = meta.om.run_key_deleting_service_once(limit=10_000)
        time.sleep(1.5)  # three of the daemon's own passes and heartbeats
        if purged or len(present()) != len(blocks):
            raise AssertionError(f"snapshot (f): {purged} keys purged, "
                                 f"{len(present())} of {len(blocks)} chunk files left "
                                 "while snapshots exist")
        print(f"snapshot (f): with snapshots, the key-deleting service purged 0 "
              f"keys; all {len(blocks)} chunk files of the 5 deleted or "
              f"overwritten versions stayed on their datanodes")
        t0 = time.perf_counter()
        for bname in ("obs", "fso"):
            names = [s["name"] for s in om.list_snapshots("snapv", bname)]
            for name in reversed(names):  # newest first: each merges down
                if (bname, name) == ("obs", "s1"):
                    for k in over + gone:  # s1 still answers after the merges
                        if om.snapshot_lookup_key("snapv", bname, "s1",
                                                  k)["size"] != v1["obs"][k].size:
                            raise AssertionError(f"snapshot (f): s1's {k} changed")
                om.delete_snapshot("snapv", bname, name)
        t_last = time.perf_counter()
        del_s = t_last - t0

        def purge() -> bool:
            with meta.scm_service.lock:
                meta.om.run_key_deleting_service_once(limit=10_000)
            return not present()

        wait_for("snapshot (f): chunk files gone", purge, 60, 0.1)
        purge_s = time.perf_counter() - t_last
        out["purge_s"] = purge_s
        print(f"snapshot (f): {n_extra + 4} snapshots deleted newest first in "
              f"{del_s:.3f} s; the last chunk file gone {purge_s:.3f} s after the "
              "last delete")

        # ---- (g) quota, repair, HttpFS and the CLI
        qb = vol.create_bucket("quota", replication=rs)
        qb.write_key("q0", payload(2, 5))
        used = om.bucket_info("snapv", "quota")["used_bytes"]
        sh("bucket", "setquota", "/snapv/quota", "--quota", str(used + cell))
        before = {b["name"]: (b.get("used_bytes"), b.get("key_count"))
                  for b in om.list_buckets("snapv")}
        mark = begin()
        refused = code(lambda: qb.write_key("q1", payload(2, 6)))
        launches = end("snapshot (g) refused PUT", "snapshot_quota_put", mark)
        q = om.bucket_info("snapv", "quota")
        if refused != "QUOTA_EXCEEDED" or (q["used_bytes"], q["key_count"]) != \
                before["quota"] or code(lambda: om.lookup_key(
                    "snapv", "quota", "q1")) != "KEY_NOT_FOUND":
            raise AssertionError(f"snapshot (g): PUT past the quota: {refused}, {q}")
        om.repair_quota("snapv")
        after = {b["name"]: (b.get("used_bytes"), b.get("key_count"))
                 for b in om.list_buckets("snapv")}
        if after != before:
            raise AssertionError(f"snapshot (g): repair {after} != {before}")
        gw = HttpFSGateway(oz, replication=rs)
        gw.start()
        try:
            statuses = []
            for method, params in (
                    ("PUT", "op=CREATESNAPSHOT&snapshotname=h1"),
                    ("GET", "op=GETSNAPSHOTDIFF&oldsnapshotname=h1&snapshotname="),
                    ("DELETE", "op=DELETESNAPSHOT&snapshotname=h1")):
                req = urllib.request.Request(
                    f"http://{gw.address}/webhdfs/v1/snapv/obs?{params}",
                    method=method)
                try:
                    with urllib.request.urlopen(req, timeout=60) as r:
                        statuses.append(r.status)
                except urllib.error.HTTPError as e:
                    statuses.append(e.code)
        finally:
            gw.stop()
        if statuses != [200, 200, 200]:
            raise AssertionError(f"snapshot (g): HttpFS answered {statuses}")
        t0 = time.perf_counter()
        sh("snapshot", "create", "/snapv/obs", "--name", "c1")
        listed = [s["name"] for s in json.loads(sh("snapshot", "list", "/snapv/obs"))]
        paged = sh("snapshot", "diff", "/snapv/obs", "--name", "c1",
                   "--page-size", "100")
        sh("snapshot", "delete", "/snapv/obs", "--name", "c1")
        cli_s = time.perf_counter() - t0
        if listed != ["c1"] or paged.strip() or om.list_snapshots("snapv", "obs"):
            raise AssertionError(f"snapshot (g): CLI listed {listed}, diff {paged!r}")
        print(f"snapshot (g): a PUT past a quota of usage + 1 cell refused "
              f"QUOTA_EXCEEDED, usage unchanged ({launches} launches); repair_quota "
              f"gave every bucket's usage back; HttpFS CREATESNAPSHOT, "
              f"GETSNAPSHOTDIFF, DELETESNAPSHOT {statuses}; `sh snapshot create|"
              f"list|diff|delete` as processes {cli_s:.2f} s")
    return out


@contextlib.contextmanager
def env_set(**values):
    """The enclosed block runs with these environment variables set."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def geo_path(device, cell: int, bpc: int, seed: int, src_scheme: str = "",
             dst_scheme: str = "", n_dn: int = 10, n_dst: int = 6, n_big: int = 4,
             big_cells: int = 64, n_logs: int = 16, log_cells: int = 4,
             n_src2: int = 2, freon_keys: int = 12, processes: bool = True) -> dict:
    """Geo replication (the reference's extension; rules in AWS S3's
    PutBucketReplication shape) between two daemon clusters in this
    process: a source ScmOmDaemon with `n_dn` DatanodeDaemons (a spare
    among them), `src_scheme` (rs-6-3 at `cell` by default), and a
    destination with `n_dst`; the source's shipper dials the destination
    over the RPC. Until (f) every cycle is driven through GeoRunNow and
    the daemon's own cadence is held off. (a) Bucket `src` gets `n_big`
    keys of `big_cells` cells and odd tails and `n_logs` of `log_cells`
    cells + 7 B under logs/, `src2` `n_src2` of `big_cells` cells +
    12 345 B, PUT concurrently. (b) Rule `logs` (to `dr-logs`, the
    destination scheme as its StorageClass) through the S3 gateway's PUT
    ?replication in the ARN form, rule `all` (to `dr`, --scheme, --append)
    through `replication set`; GET ?replication re-PUTs unchanged and
    `replication get` gives the same rules. (c) The bootstrap: every key
    byte-exact at its rule's destination, RS at `dst_scheme` with every
    unit and CRC checked, the markers naming the source row, no decode;
    a second cycle ships nothing. (d) A source overwrite beaten by a later
    destination overwrite, then the source's delete of the key: each
    cycle counts one conflict and the destination's bytes stay. (e) A
    datanode holding data units of src2's keys stopped, a rule installed
    on src2: its bootstrap reads degraded (decodes at the source),
    byte-exact at `dr2`. (f) The source daemon restarted on its store with
    OZONE_TPU_GEO_PERIOD_S=0.5: its first cycle ships nothing already
    shipped; 4 writers overwrite 2 keys, delete 2, add 4 under logs/ and
    rename 1; GeoStatus polled until the lag is 0 and every destination
    bucket holds its source's names, bytes and markers (seconds from the
    last commit, peak lag). (g) `freon geo` against the destination,
    `replication status`, DELETE ?replication on every bucket, after
    which PUTs, a GeoRunNow and two periods leave `system/geo_state` as it
    was. With `processes` the CLI verbs run as processes. Launches equal
    the codec service's dispatches in every step, split by form (the
    source's decodes, both clusters' encodes)."""
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.gateway.s3 import S3Gateway
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.net.scm_service import RemoteScmClient
    from ozone_tpu_torch.replication_geo.shipper import METRICS as GEO
    from ozone_tpu_torch.tools import freon

    src_scheme = src_scheme or f"rs-6-3-{cell // 1024}k"
    dst_scheme = dst_scheme or f"rs-3-2-{cell // 1024}k"
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    rng = np.random.default_rng(seed + 19)
    gib = float(1 << 30)
    vol = "s3v"  # the gateway's volume
    out: dict = {"launches": {}, "step_s": {}}
    lap_t = [time.perf_counter()]

    def lap(step: str) -> None:
        now = time.perf_counter()
        out["step_s"][step] = round(now - lap_t[0], 3)
        lap_t[0] = now

    # the phase drives every cycle itself until (f): no sweep and no
    # cycle of the daemons' own, and a budget no bootstrap runs into
    held = {"OZONE_TPU_LIFECYCLE_PERIOD_S": 1e9, "OZONE_TPU_GEO_PERIOD_S": 1e9,
            "OZONE_TPU_GEO_DEADLINE_S": 600}
    meta_kw = dict(block_size=16 * cell, container_size=4096 * cell,
                   stale_after_s=30.0, dead_after_s=60.0, background_interval_s=0.5,
                   placement_seed=seed, device=device)

    def begin() -> dict:
        fused_kernel.launches.reset()
        return service_counts()

    def end(what: str, key: str, mark: dict) -> dict:
        """The step's launches by form; launches equal dispatches."""
        launches = fused_kernel.launches.count
        delta = service_delta(mark)
        check_launches_equal(what, device, launches, delta)
        forms = {f: delta[f"dispatches_{f}"] for f in ("encode", "decode")}
        print(f"{what}: dispatches by form {forms}")
        out["launches"][key] = out["launches"].get(key, 0) + launches
        return forms

    def cli(*argv) -> object:
        """A `replication` verb of the port's CLI (a process with
        `processes`): its JSON answer."""
        if not processes:
            return cli_json(*argv)
        proc = subprocess.run([sys.executable, "-m", "ozone_tpu_torch.tools", *argv],
                              capture_output=True, text=True, timeout=120,
                              cwd=str(repo), env=env)
        if proc.returncode != 0:
            raise AssertionError(f"CLI {' '.join(argv)} exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        return json.loads(proc.stdout)

    def start_cluster(root: Path, n: int):
        with env_set(**held):
            meta = ScmOmDaemon(root / "om.db", **meta_kw)
        meta.start()
        dns = []
        for i in range(n):
            d = DatanodeDaemon(root / f"dn{i}", f"dn{i}", meta.address,
                               heartbeat_interval_s=0.5, device=device)
            d.start()
            dns.append(d)
        scm = RemoteScmClient(meta.address)
        try:
            wait_for(f"{n} datanodes registered",
                     lambda: len(scm.status()["nodes"]) == n, 30)
        finally:
            scm.close()
        return meta, dns

    def client(meta, clients):
        return OzoneClient(RemoteOmClient(meta.address, clients=clients), clients,
                           device=device)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-geo-") as tmp:
        root = Path(tmp)
        metas: dict = {}
        dns_all: list = []
        fs = [DatanodeClientFactory(), DatanodeClientFactory()]
        ozs: list = []
        gw = None
        try:
            metas["src"], src_dns = start_cluster(root / "src", n_dn)
            dns_all += src_dns
            metas["dst"], dst_dns = start_cluster(root / "dst", n_dst)
            dns_all += dst_dns
            src_oz, dst_oz = client(metas["src"], fs[0]), client(metas["dst"], fs[1])
            ozs += [src_oz, dst_oz]
            dst_addr = metas["dst"].address
            dst_by_id = {d.dn.id: d for d in dst_dns}

            # (a) setup
            src_oz.create_volume(vol)
            for b in ("src", "src2"):
                src_oz.om.create_bucket(vol, b, src_scheme)
            truth: dict = {}  # (bucket, name) -> bytes at the source
            for i in range(n_big):
                truth[("src", f"big-{i}")] = rng.integers(
                    0, 256, big_cells * cell + 12345 + 1000 * i, dtype=np.uint8)
            for i in range(n_logs):
                truth[("src", f"logs/{i:02d}")] = rng.integers(
                    0, 256, log_cells * cell + 7, dtype=np.uint8)
            for i in range(n_src2):
                truth[("src2", f"k-{i}")] = rng.integers(
                    0, 256, big_cells * cell + 12345, dtype=np.uint8)

            def put(item):
                (b, name), data = item
                src_oz.get_volume(vol).get_bucket(b).write_key(name, data)

            mark = begin()
            t0 = time.perf_counter()
            concurrent(put, list(truth.items()))
            secs = time.perf_counter() - t0
            total = sum(v.size for v in truth.values())
            forms = end("geo (a) setup PUT", "geo_setup_put", mark)
            if device.type == "cuda" and forms["encode"] <= 0:
                raise AssertionError("geo (a): no encode launched")
            print(f"geo (a) setup: {len(truth)} keys, {total} B in {secs:.3f} s, "
                  f"{total / gib / secs:.3f} GiB/s")
            out["setup_gib_s"] = total / gib / secs
            lap("a")

            # (b) rules: S3 ?replication, then `replication set --append`
            gw = S3Gateway(src_oz, port=0, replication=src_scheme)
            gw.start()
            s3 = S3Client(gw.address, "", "")
            body = ("<ReplicationConfiguration><Role></Role><Rule><ID>logs</ID>"
                    "<Status>Enabled</Status><Filter><Prefix>logs/</Prefix></Filter>"
                    f"<Destination><Bucket>arn:aws:s3:{dst_addr}::dr-logs</Bucket>"
                    f"<StorageClass>{dst_scheme}</StorageClass></Destination>"
                    "</Rule></ReplicationConfiguration>").encode()
            s3.ok("PUT", "/src?replication", body, sign=False)
            set_out = cli("replication", "set", f"/{vol}/src", "--dest", dst_addr,
                          "--dest-bucket", "dr", "--scheme", dst_scheme, "--append",
                          "--id", "all", "--om", metas["src"].address)
            rules = src_oz.om.get_bucket_geo_replication(vol, "src")
            if [r["id"] for r in rules] != ["logs", "all"] or set_out != rules:
                raise AssertionError(f"geo (b): rules {rules}, CLI answered {set_out}")
            _, xml1 = s3.ok("GET", "/src?replication", sign=False)
            s3.ok("PUT", "/src?replication", xml1, sign=False)
            _, xml2 = s3.ok("GET", "/src?replication", sign=False)
            got = cli("replication", "get", f"/{vol}/src", "--om", metas["src"].address)
            if xml2 != xml1 or got != rules \
                    or src_oz.om.get_bucket_geo_replication(vol, "src") != rules:
                raise AssertionError("geo (b): GET ?replication does not re-PUT "
                                     "unchanged, or the CLI's rules differ")
            print(f"geo (b): rules {[(r['id'], r['prefix'], r['bucket'], r['scheme']) for r in rules]}; "
                  "GET ?replication re-PUT unchanged, `replication get` equal")
            lap("b")

            def dest_of(b: str, name: str) -> str:
                if b == "src2":
                    return "dr2"
                return "dr-logs" if name.startswith("logs/") else "dr"

            def check_dest(what: str, keys, ec_check=(), read=True) -> None:
                """Every (bucket, name) of `keys` at its destination RS at
                dst_scheme and marked with its source row's current
                version, byte-exact unless `read` is off; `ec_check` keys
                have every unit and CRC checked."""
                def one(item):
                    b, name = item
                    sinfo = metas["src"].om.lookup_key(vol, b, name)
                    dinfo = dst_oz.om.lookup_key(vol, dest_of(b, name), name)
                    meta = dinfo.get("metadata") or {}
                    if str(dinfo["replication"]) != dst_scheme \
                            or meta.get("geo-src") != f"/{vol}/{b}" \
                            or meta.get("geo-src-oid") != sinfo["object_id"]:
                        raise AssertionError(f"{what}: {b}/{name} at the destination is "
                                             f"{dinfo['replication']} with {meta}")
                    if not read:
                        return
                    data = dst_oz.get_volume(vol).get_bucket(
                        dest_of(b, name)).read_key_info(dinfo)
                    if not np.array_equal(data, truth[(b, name)]):
                        raise AssertionError(f"{what}: {b}/{name} differs at the "
                                             "destination")
                    if (b, name) in ec_check:
                        check_ec_units(lambda i: dst_by_id[i].dn,
                                       metas["dst"].om.key_block_groups(dinfo),
                                       truth[(b, name)], bpc, f"{what} {name}",
                                       crc_route="native")

                concurrent(one, list(keys))

            # (c) the bootstrap over GeoRunNow
            mark = begin()
            t0 = time.perf_counter()
            stats = src_oz.om.run_geo_once()
            secs = time.perf_counter() - t0
            forms = end("geo (c) bootstrap", "geo_bootstrap", mark)
            n_src = n_big + n_logs
            if not stats["complete"] or stats["failed"] or stats["bootstrapped"] != 1 \
                    or stats["keys_shipped"] != n_src:
                raise AssertionError(f"geo (c): cycle {stats}")
            if forms["decode"] != 0 or (device.type == "cuda" and forms["encode"] <= 0):
                raise AssertionError(f"geo (c): dispatches by form {forms}")
            src_keys = [k for k in truth if k[0] == "src"]
            check_dest("geo (c)", src_keys,
                       ec_check=[("src", "big-0")] + [k for k in src_keys
                                                      if k[1].startswith("logs/")])
            print(f"geo (c) bootstrap: {stats['keys_shipped']} keys, {stats['bytes']} B "
                  f"in {secs:.3f} s, {stats['bytes'] / gib / secs:.3f} GiB/s; encode "
                  f"launches {forms['encode']}, decode {forms['decode']}; every key "
                  f"byte-exact at {dst_scheme}, units and CRCs checked on "
                  f"{1 + n_logs} keys")
            out["bootstrap_gib_s"] = stats["bytes"] / gib / secs
            out["bootstrap_s"] = secs
            again = src_oz.om.run_geo_once()
            if again["keys_shipped"] or again["bytes"]:
                raise AssertionError(f"geo (c): an unchanged cycle shipped {again}")
            lap("c")

            # (d) last-writer-wins, both ways
            contested = "logs/00"
            src_b = src_oz.get_volume(vol).get_bucket("src")
            mark = begin()
            src_b.write_key(contested, rng.integers(0, 256, log_cells * cell + 7,
                                                    dtype=np.uint8))
            local = rng.integers(0, 256, log_cells * cell + 99, dtype=np.uint8)
            dst_oz.get_volume(vol).get_bucket("dr-logs").write_key(contested, local)
            c1 = src_oz.om.run_geo_once()
            src_b.delete_key(contested)
            c2 = src_oz.om.run_geo_once()
            end("geo (d) conflicts", "geo_conflicts", mark)
            del truth[("src", contested)]
            left = dst_oz.get_volume(vol).get_bucket("dr-logs").read_key(contested)
            if (c1["conflicts"], c2["conflicts"], c1["keys_shipped"],
                    c2["deletes_shipped"]) != (1, 1, 0, 0) \
                    or not np.array_equal(left, local):
                raise AssertionError(f"geo (d): cycles {c1}, {c2}; the destination's "
                                     "own bytes did not stay")
            print("geo (d): a stale replay and the source's delete each counted one "
                  "conflict; the destination's own bytes stayed")
            lap("d")

            # (e) src2's bootstrap reads degraded at the source
            g0 = metas["src"].om.lookup_key(vol, "src2", "k-0")["block_groups"][0]
            victim = next(d for d in src_dns if d.dn.id == g0["nodes"][0])
            stop_server(victim)
            try:
                src_oz.om.set_bucket_geo_replication(vol, "src2", [{
                    "id": "dr2", "endpoint": dst_addr, "bucket": "dr2",
                    "scheme": dst_scheme}])
                mark = begin()
                t0 = time.perf_counter()
                stats = src_oz.om.run_geo_once()
                secs = time.perf_counter() - t0
                forms = end("geo (e) degraded ship", "geo_degraded_ship", mark)
            finally:
                restart_server(victim)
            if stats["keys_shipped"] != n_src2 or stats["failed"] \
                    or forms["decode"] <= 0 \
                    or (device.type == "cuda" and forms["encode"] <= 0):
                raise AssertionError(f"geo (e): cycle {stats}, dispatches {forms}")
            check_dest("geo (e)", [k for k in truth if k[0] == "src2"])
            print(f"geo (e) degraded source ({victim.dn.id} stopped): {stats['bytes']} B "
                  f"in {secs:.3f} s, {stats['bytes'] / gib / secs:.3f} GiB/s; decode "
                  f"launches {forms['decode']}, encode {forms['encode']}; byte-exact")
            out["degraded_gib_s"] = stats["bytes"] / gib / secs
            out["forms"] = {"degraded_decode": forms["decode"],
                            "degraded_encode": forms["encode"]}
            lap("e")

            # (f) restart on the store, then churn under the cadence
            cycles0 = GEO.counter("cycles").value
            shipped0 = (GEO.counter("keys_shipped").value,
                        GEO.counter("deletes_shipped").value)
            gaps0 = GEO.counter("journal_gaps").value
            mark = begin()
            port = metas["src"].server.port
            # the datanodes' failed heartbeats while it is down are
            # expected: their records are held back, printed on a failure
            collect = _Collect()
            port_log = logging.getLogger("ozone_tpu_torch")
            old_propagate, port_log.propagate = port_log.propagate, False
            port_log.addHandler(collect)
            t0 = time.perf_counter()
            try:
                metas.pop("src").stop()
                with env_set(**{**held, "OZONE_TPU_GEO_PERIOD_S": 0.5}):
                    metas["src"] = ScmOmDaemon(root / "src" / "om.db", port=port,
                                               min_datanodes=n_dn, **meta_kw)
                metas["src"].start()
                wait_for("geo (f): every source datanode registered", lambda: all(
                    metas["src"].scm.nodes.get(d.dn.id) is not None
                    for d in src_dns), 30)
                wait_for("geo (f): the first cycle after the restart",
                         lambda: GEO.counter("cycles").value > cycles0, 30)
            except BaseException:
                collect.dump()
                raise
            finally:
                port_log.removeHandler(collect)
                port_log.propagate = old_propagate
            restart_s = time.perf_counter() - t0
            resumed = (GEO.counter("keys_shipped").value,
                       GEO.counter("deletes_shipped").value)
            if resumed != shipped0:
                raise AssertionError(f"geo (f): the first cycle after the restart "
                                     f"shipped {resumed} against {shipped0}")
            # a new client and gateway: the old ones' channel died with it
            gw.stop()
            src_oz.om.close()
            src_oz = ozs[0] = client(metas["src"], fs[0])
            src_b = src_oz.get_volume(vol).get_bucket("src")
            gw = S3Gateway(src_oz, port=0, replication=src_scheme)
            gw.start()
            s3 = S3Client(gw.address, "", "")
            ops: list = []
            for name in ("big-1", "logs/01"):
                truth[("src", name)] = rng.integers(0, 256, truth[("src", name)].size,
                                                    dtype=np.uint8)
                ops.append(("put", name))
            for name in ("big-2", "logs/02"):
                del truth[("src", name)]
                ops.append(("delete", name))
            for i in range(4):
                name = f"logs/new-{i}"
                truth[("src", name)] = rng.integers(0, 256, log_cells * cell + 7,
                                                    dtype=np.uint8)
                ops.append(("put", name))
            truth[("src", "logs/03-renamed")] = truth.pop(("src", "logs/03"))
            ops.append(("rename", "logs/03"))

            def writer(w: int) -> None:
                for op, name in ops[w::4]:
                    if op == "put":
                        src_b.write_key(name, truth[("src", name)])
                    elif op == "delete":
                        src_b.delete_key(name)
                    else:
                        src_b.rename_key(name, name + "-renamed")

            concurrent(writer, list(range(4)))
            t_last = time.perf_counter()
            peak = {"entries": 0, "seconds": 0.0}

            def expected() -> set:
                return {(dest_of(b, n), n) for b, n in truth}

            def marked() -> set:
                return {(db, k["name"]) for db in ("dr", "dr-logs", "dr2")
                        for k in dst_oz.om.list_keys(vol, db)
                        if (k.get("metadata") or {}).get("geo-src")}

            def converged() -> bool:
                lag = src_oz.om.geo_status()["lag"]
                peak["entries"] = max(peak["entries"], lag["entries"])
                peak["seconds"] = max(peak["seconds"], lag["seconds"])
                return lag["entries"] == 0 and marked() == expected()

            wait_for("geo (f): the churn converged", converged, 60, poll_s=0.05)
            conv_s = time.perf_counter() - t_last
            end("geo (f) restart and churn", "geo_churn", mark)
            # the churned keys byte-exact; every other key's marker names
            # its source row's current version, whose bytes (c) and (e) read
            churned = {("src", n) for _, n in ops} | {("src", "logs/03-renamed")}
            check_dest("geo (f)", [k for k in truth if k in churned])
            check_dest("geo (f)", [k for k in truth if k not in churned], read=False)
            print(f"geo (f): restarted in {restart_s:.3f} s ({len(collect.records)} "
                  f"warning log records held back); resumed at the durable cursor "
                  f"(its first cycle shipped nothing; journal gaps "
                  f"{GEO.counter('journal_gaps').value - gaps0}, the cursor predating "
                  f"the store's restart); the churn of {len(ops)} operations converged "
                  f"{conv_s:.3f} s after the last commit, peak lag "
                  f"{peak['entries']} entries, {peak['seconds']:.3f} s")
            out.update(converge_s=conv_s, peak_lag_entries=peak["entries"],
                       peak_lag_s=peak["seconds"])
            lap("f")

            # (g) freon geo, replication status, DELETE ?replication
            metas["src"]._geo_period = 1e9  # freon's cycles run alone
            while src_oz.om.run_geo_once().get("skipped"):
                time.sleep(0.05)
            mark = begin()
            argv = ["freon", "geo", "-n", str(freon_keys), "-s", str(4 * cell + 7),
                    "--dest", dst_addr, "--om", metas["src"].address, "--device",
                    device.type]
            rep = cli(*argv)
            end("geo (g) freon geo", "geo_freon", mark)
            if (rep["failures"], rep["verify_failures"], rep["lag_entries"]) != (0, 0, 0):
                raise AssertionError(f"geo (g): freon geo reported {rep}")
            status = cli("replication", "status", "--om", metas["src"].address)
            if status["lag"]["entries"] != 0:
                raise AssertionError(f"geo (g): replication status {status['lag']}")
            for b in ("src", "src2"):
                s3.ok("DELETE", f"/{b}?replication", status=204, sign=False)
                s3.ok("GET", f"/{b}?replication", status=404, sign=False)
            src_oz.om.delete_bucket_geo_replication("freon-vol", "freon-geo")
            row = json.loads(json.dumps(metas["src"].om.store.get("system", "geo_state")))
            metas["src"]._geo_last, metas["src"]._geo_period = 0.0, 0.5
            src_b.write_key("after-rules", rng.integers(0, 256, cell, dtype=np.uint8))
            idle = src_oz.om.run_geo_once()
            time.sleep(1.2)  # two periods of the cadence
            if metas["src"].om.store.get("system", "geo_state") != row \
                    or idle["keys_shipped"]:
                raise AssertionError("geo (g): a rule-less cluster changed its geo "
                                     "state")
            print(f"geo (g): freon geo {rep['ops']} keys, shipped {rep['shipped']}, "
                  f"deletes {rep['deletes_shipped']}, verify failures 0, lag 0; "
                  "`replication status` lag 0; with every rule deleted, PUTs, a "
                  "GeoRunNow and two periods left system/geo_state unchanged")
            lap("g")
            print(f"geo step seconds: {out['step_s']}")
        finally:
            if gw is not None:
                gw.stop()
            for oz in ozs:
                oz.om.close()
            for f in fs:
                f.close()
            for d in dns_all:
                d.stop()
            for meta in metas.values():
                meta.stop()
    return out


def shard_path(device, cell: int, bpc: int, seed: int, n_keys: int = 8,
               key_cells: int = 64, mig_cells: int = 4, ommg_ops: int = 600,
               omkg_keys: int = 1500, shardd_keys: int = 600) -> dict:
    """The sharded metadata plane (docs/OPERATIONS.md "Sharded metadata
    plane", the deployment of bench.py's bench_meta_ops): four shards over
    64 slots under an epoch-numbered root map, their data in rs-6-3 at
    `cell` with CRC32C over `bpc`, all shards sharing the SCM of one
    MiniOzoneCluster of 10 datanodes. (a) A plain plane of 4 shards, 8 EC
    buckets (two per shard, named by slot), 4 writers PUT `n_keys` keys of
    `key_cells` cells and odd tails (GiB/s); two keys' units and CRC words
    equal the numpy coder's; every key reads back byte-exact; the
    `om.shard` routes. (b) Three cross-shard renames: a coordinator crash
    between the prepares then `recover` (presumed abort, the source key
    byte-exact), a crash after the decision then `recover` (commit; the
    key only under its new name), and one without a crash; no launch and
    no chunk write; ms per rename and the 2PC counters. (c) One data-unit
    holder of a renamed key stopped: its GET decodes on the card,
    byte-exact (GiB/s). (d) `migrate_slot` moves an EC bucket's slot to
    another shard while 4 writers PUT keys of `mig_cells` cells into it:
    every acknowledged key reads back byte-exact from the new owner
    (moved rejections, slots migrated, migration seconds). (e) A bucket
    link on one shard to a source on another: a GET through it
    byte-exact. (f) Ring mode, 2 shards of 3 replicas with follower reads
    on: ommg `ommg_ops` ops of the `rl` mix over 4 buckets, 8 threads, hit
    rate >= 0.8; a shard leader killed in the middle of a cross-shard
    rename, the key under exactly one name. (g) Over the RPC:
    MiniShardedCluster(n_shards=2) routes a client that rides out a
    `move_slot`; `admin shards map` through the CLI; omkg ops/s with
    `omkg_keys` keys at 1, 2 and 4 in-process shards and with
    `shardd_keys` keys at 1 and 4 shardd processes (their start seconds,
    exit 0 on SIGTERM) beside os.cpu_count(). Launches equal the codec
    service's dispatches in every step."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.om.metadata import key_key
    from ozone_tpu_torch.om.requests import OMError
    from ozone_tpu_torch.om.sharding import METRICS as SHARD
    from ozone_tpu_torch.om.sharding.plane import ShardedMetaPlane
    from ozone_tpu_torch.om.sharding.shardmap import SHARD_MOVED, ShardMap, slot_for
    from ozone_tpu_torch.om.sharding.txn import ShardPrepare, TxnJournal
    from ozone_tpu_torch.testing.minicluster import (
        MiniOzoneCluster,
        MiniShardedCluster,
        free_ports,
    )
    from ozone_tpu_torch.tools import freon

    rs = f"rs-6-3-{cell // 1024}k"
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    card = nvidia_smi() if device.type == "cuda" else "cpu"
    rng = np.random.default_rng(seed + 20)
    gib = float(1 << 30)
    out: dict = {"launches": {}}
    counters = ("routes", "moved_rejections", "slots_migrated", "cross_shard_prepares",
                "cross_shard_commits", "cross_shard_aborts", "follower_read_hits",
                "follower_read_misses")

    def shard_counts() -> dict:
        return {c: SHARD.counter(c).value for c in counters}

    def begin() -> dict:
        fused_kernel.launches.reset()
        return service_counts()

    def end(what: str, key: str, mark: dict, decode: bool = False) -> int:
        launches = fused_kernel.launches.count
        check_launches_equal(what, device, launches, service_delta(mark))
        if decode and device.type == "cuda" and launches <= 0:
            raise AssertionError(f"{what}: no decode launched")
        out["launches"][key] = out["launches"].get(key, 0) + launches
        return launches

    def bucket_on(m: ShardMap, sid: str, prefix: str) -> str:
        """A bucket name whose slot the map gives to `sid`."""
        return next(f"{prefix}{i}" for i in range(10_000)
                    if m.shard_for("shardv", f"{prefix}{i}") == sid)

    def code(fn) -> str | None:
        try:
            fn()
        except OMError as e:
            return e.code
        return None

    def chunk_writes(mini) -> int:
        return sum(dn.metrics.histogram("chunk_write_seconds").count
                   for dn in mini.datanodes)

    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-shard-") as tmp:
        root = Path(tmp)
        mini = MiniOzoneCluster(root / "data", num_datanodes=10, block_size=16 * cell,
                                container_size=64 * 16 * cell, stale_after_s=1e6,
                                dead_after_s=2e6, placement_seed=seed, device=device)
        plane = ShardedMetaPlane(root / "meta", n_shards=4, scm=mini.scm,
                                 clients=mini.clients, device=device)
        try:
            f = plane.facade
            oz = plane.client(mini.clients)
            vol = oz.create_volume("shardv")
            m = plane.current_map()
            names = [bucket_on(m, sid, p) for p in ("ec-a", "ec-b") for sid in plane.shard_ids]
            for b in names:
                vol.create_bucket(b, replication=rs)

            # ---- (a) EC writes through the plane, 4 writers
            keys = {(names[i % len(names)], f"k{i}"):
                    rng.integers(0, 256, key_cells * cell + 1000 * i + 7, dtype=np.uint8)
                    for i in range(n_keys)}
            items = list(keys.items())
            c0 = shard_counts()
            mark = begin()
            t0 = time.perf_counter()
            concurrent(lambda part: [vol.get_bucket(b).write_key(k, d) for (b, k), d in part],
                       [items[w::4] for w in range(4)])
            secs = time.perf_counter() - t0
            launches = end("shard (a) EC PUTs", "shard_ec_put", mark)
            total = sum(d.size for d in keys.values())
            out["put_gib_s"] = total / secs / gib
            for (b, k), d in items[:2]:
                info = f.lookup_key("shardv", b, k)
                check_ec_units(mini.datanode, f.key_block_groups(info), d, bpc,
                               f"shard (a) {b}/{k}")
            for (b, k), d in items:
                if not np.array_equal(vol.get_bucket(b).read_key(k), d):
                    raise AssertionError(f"shard (a): {b}/{k} differs")
            per_shard = {sid: len(list(plane.shards[sid].om.store.iterate("keys")))
                         for sid in plane.shard_ids}
            if sorted(per_shard.values()) != [n_keys // 4] * 4:
                raise AssertionError(f"shard (a): keys per shard {per_shard}")
            routes = SHARD.counter("routes").value - c0["routes"]
            print(f"shard (a): {n_keys} keys, {total} B over {len(names)} {rs} buckets "
                  f"(2 per shard) by 4 writers in {secs:.3f} s = {out['put_gib_s']:.3f} "
                  f"GiB/s, {launches} launches; 2 keys' units and CRCs equal the numpy "
                  f"coder's, every key byte-exact; keys per shard {per_shard}; om.shard "
                  f"routes {routes} [{card}]")

            # ---- (b) cross-shard renames, with a coordinator crash twice
            (b0, k0), d0 = items[0]
            (b1, k1), d1 = items[1]
            (b2, k2), d2 = items[2]

            def dst_of(b):
                """A bucket of the other shards' (the rename's destination)."""
                src_sid = m.shard_for("shardv", b)
                return next(x for x in names if m.shard_for("shardv", x) != src_sid)

            c0, w0 = shard_counts(), chunk_writes(mini)
            mark = begin()
            ms = {}

            def journal(txn, b, k, new):
                rec = {"kind": "rename", "volume": "shardv", "src_bucket": b, "key": k,
                       "dst_bucket": dst_of(b), "new_key": new,
                       "src_shard": m.shard_for("shardv", b),
                       "dst_shard": m.shard_for("shardv", dst_of(b)), "epoch": m.epoch}
                plane.root.submit(TxnJournal(txn, "begin", rec))
                info = plane.shards[rec["src_shard"]].submit(ShardPrepare(
                    txn, "rename_src", {"volume": "shardv", "bucket": b, "key": k},
                    epoch=m.epoch))
                return rec, info

            t0 = time.perf_counter()
            journal("crash-between-prepares", b0, k0, "k0-renamed")
            resolved = plane.recover()
            ms["abort_on_recover"] = 1e3 * (time.perf_counter() - t0)
            if [r["phase"] for r in resolved] != ["begin"] or \
                    not np.array_equal(vol.get_bucket(b0).read_key(k0), d0) or \
                    code(lambda: f.lookup_key("shardv", dst_of(b0), "k0-renamed")) \
                    != "KEY_NOT_FOUND":
                raise AssertionError(f"shard (b): presumed abort failed: {resolved}")
            t0 = time.perf_counter()
            rec, info = journal("crash-after-decide", b1, k1, "k1-renamed")
            plane.shards[rec["dst_shard"]].submit(ShardPrepare(
                "crash-after-decide", "rename_dst",
                {"volume": "shardv", "bucket": rec["dst_bucket"], "new_key": "k1-renamed",
                 "info": info}, epoch=m.epoch))
            plane.root.submit(TxnJournal("crash-after-decide", "decide-commit", rec))
            resolved = plane.recover()
            ms["commit_on_recover"] = 1e3 * (time.perf_counter() - t0)
            renamed = {(rec["dst_bucket"], "k1-renamed"): d1}
            if [r["phase"] for r in resolved] != ["decide-commit"] or \
                    code(lambda: f.lookup_key("shardv", b1, k1)) != "KEY_NOT_FOUND":
                raise AssertionError(f"shard (b): the decided rename did not commit: "
                                     f"{resolved}")
            t0 = time.perf_counter()
            f.rename_key_cross("shardv", b2, k2, dst_of(b2), "k2-renamed")
            ms["rename"] = 1e3 * (time.perf_counter() - t0)
            renamed[(dst_of(b2), "k2-renamed")] = d2
            if code(lambda: f.lookup_key("shardv", b2, k2)) != "KEY_NOT_FOUND":
                raise AssertionError("shard (b): the renamed key still reads at its source")
            for (b, k), d in renamed.items():
                if not np.array_equal(vol.get_bucket(b).read_key(k), d):
                    raise AssertionError(f"shard (b): {b}/{k} differs after the rename")
            launches = end("shard (b) cross-shard renames", "shard_cross_rename", mark)
            writes = chunk_writes(mini) - w0
            if launches or writes:
                raise AssertionError(f"shard (b): {launches} launches, {writes} chunk "
                                     "writes in the renames")
            c1 = shard_counts()
            twopc = {c: c1[c] - c0[c] for c in ("cross_shard_prepares",
                                                "cross_shard_commits", "cross_shard_aborts")}
            if twopc != {"cross_shard_prepares": 2, "cross_shard_commits": 2,
                         "cross_shard_aborts": 1}:
                raise AssertionError(f"shard (b): 2PC counters {twopc}")
            out["rename_ms"] = ms
            print(f"shard (b): a crash between the prepares, recovered (presumed abort) "
                  f"in {ms['abort_on_recover']:.2f} ms; a crash after the decision, "
                  f"recovered (commit) in {ms['commit_on_recover']:.2f} ms; a rename "
                  f"without a crash {ms['rename']:.2f} ms; every key byte-exact under "
                  f"exactly one name; 0 launches, 0 chunk writes; {twopc} [{card}]")

            # ---- (c) degraded GET of a renamed key
            (rb, rk), rd = next(iter(renamed.items()))
            info = f.lookup_key("shardv", rb, rk)
            victim = f.key_block_groups(info)[0].pipeline.nodes[0]
            mini.stop_datanode(victim)
            mark = begin()
            t0 = time.perf_counter()
            got = vol.get_bucket(rb).read_key(rk)
            secs = time.perf_counter() - t0
            launches = end("shard (c) degraded GET", "shard_degraded_get", mark, decode=True)
            if not np.array_equal(got, rd):
                raise AssertionError("shard (c): the degraded GET differs")
            mini.restart_datanode(victim)
            out["degraded_gib_s"] = rd.size / secs / gib
            print(f"shard (c): {rb}/{rk} ({rd.size} B) with data unit 0's holder {victim} "
                  f"stopped: byte-exact in {secs:.3f} s = {out['degraded_gib_s']:.3f} GiB/s, "
                  f"{launches} decode launches [{card}]")

            # ---- (d) live slot migration under 4 writers
            mig = bucket_on(m, "s0", "mig")
            vol.create_bucket(mig, replication=rs)
            base = rng.integers(0, 256, mig_cells * cell, dtype=np.uint8)
            acked: dict = {}
            refused: list = []
            lock = threading.Lock()
            phase = {"migrated": None}

            def payload(w: int, i: int) -> np.ndarray:
                d = base.copy()
                d[:8] = np.frombuffer(np.int64(w * 100_000 + i).tobytes(), np.uint8)
                return d

            def writer(w: int) -> None:
                bucket = vol.get_bucket(mig)
                i = after = 0
                while after < 3:
                    name = f"w{w}-{i}"
                    try:
                        bucket.write_key(name, payload(w, i))
                    except OMError as e:
                        if e.code != SHARD_MOVED:
                            raise
                        with lock:
                            refused.append(name)
                    else:
                        with lock:
                            acked[name] = (w, i)
                            if phase["migrated"] is not None:
                                after += 1
                    i += 1
                    if i > 400:
                        raise AssertionError("shard (d): the migration never finished")

            c0 = shard_counts()
            mark = begin()
            threads = [threading.Thread(target=writer, args=(w,)) for w in range(4)]
            for t in threads:
                t.start()
            wait_for("shard (d): 8 keys acknowledged before the migration",
                     lambda: len(acked) >= 8, 300)
            slot, target = slot_for("shardv", mig), "s3"
            t0 = time.perf_counter()
            plane.migrate_slot(slot, target)
            mig_s = time.perf_counter() - t0
            phase["migrated"] = mig_s
            for t in threads:
                t.join(timeout=600)
                if t.is_alive():
                    raise AssertionError("shard (d): a writer did not finish")
            launches = end("shard (d) PUTs across the migration", "shard_migration_put", mark)
            dst = plane.shards[target].om.store
            missing = [k for k in acked if dst.get("keys", key_key("shardv", mig, k)) is None]
            if missing:
                raise AssertionError(f"shard (d): acknowledged keys lost: {missing}")
            for name, (w, i) in sorted(acked.items()):
                if not np.array_equal(vol.get_bucket(mig).read_key(name), payload(w, i)):
                    raise AssertionError(f"shard (d): {name} differs")
            c1 = shard_counts()
            moved = c1["moved_rejections"] - c0["moved_rejections"]
            out["migration"] = {"seconds": mig_s, "acked": len(acked),
                                "refused": len(refused), "moved_rejections": moved,
                                "slots_migrated": c1["slots_migrated"] - c0["slots_migrated"]}
            print(f"shard (d): slot {slot} ({mig}) moved s0 -> {target} in {mig_s:.3f} s "
                  f"under 4 writers of {mig_cells * cell} B keys: {len(acked)} acknowledged, "
                  f"every one byte-exact from {target}; {len(refused)} refused with "
                  f"SHARD_MOVED; moved_rejections {moved}, slots_migrated "
                  f"{out['migration']['slots_migrated']}; {launches} launches [{card}]")

            # ---- (e) a cross-shard bucket link
            (lb, lk), ld = items[3]
            link = bucket_on(m, next(s for s in plane.shard_ids
                                     if s != m.shard_for("shardv", lb)), "link")
            c0 = shard_counts()
            mark = begin()
            f.create_bucket_link("shardv", lb, "shardv", link)
            t0 = time.perf_counter()
            got = vol.get_bucket(link).read_key(lk)
            secs = time.perf_counter() - t0
            end("shard (e) GET through a cross-shard link", "shard_link_get", mark)
            c1 = shard_counts()
            if not np.array_equal(got, ld) or c1["cross_shard_commits"] - \
                    c0["cross_shard_commits"] != 1:
                raise AssertionError("shard (e): the GET through the link differs")
            print(f"shard (e): link {link} on {m.shard_for('shardv', link)} -> {lb} on "
                  f"{m.shard_for('shardv', lb)} (a 2PC): GET of {lk} byte-exact in "
                  f"{secs:.3f} s = {ld.size / secs / gib:.3f} GiB/s [{card}]")
        finally:
            plane.close()
            mini.close()

        # ---- (f) ring mode: follower reads and a leader kill mid-rename
        with env_set(OZONE_TPU_OM_FOLLOWER_READS=1):
            ring = ShardedMetaPlane(root / "ring", n_shards=2, mode="ring", replicas=3,
                                    follower_reads=True, device=device)
            try:
                c0 = shard_counts()
                t0 = time.perf_counter()
                rep = freon.ommg(ring.client(), n_ops=ommg_ops, threads=8, mix="rl",
                                 buckets=4)
                secs = time.perf_counter() - t0
                c1 = shard_counts()
                hits = c1["follower_read_hits"] - c0["follower_read_hits"]
                misses = c1["follower_read_misses"] - c0["follower_read_misses"]
                rate = hits / max(1, hits + misses)
                if rep.failures or rate < 0.8:
                    raise AssertionError(f"shard (f): hit rate {rate:.3f}, "
                                         f"{rep.failures} failures")
                out["follower_hit_rate"] = rate
                rf = ring.facade
                rm = ring.current_map()
                src = next(f"r{i}" for i in range(10_000)
                           if rm.shard_for("shardv", f"r{i}") == "s0")
                dstb = next(f"r{i}" for i in range(10_000)
                            if rm.shard_for("shardv", f"r{i}") == "s1")
                rf.create_volume("shardv")
                for b in (src, dstb):
                    rf.create_bucket("shardv", b, replication="RATIS/1")
                s = rf.open_key("shardv", src, "old")
                rf.commit_key(s, [], 21)
                real = ring.coordinator._shard_submit
                killed = []

                def kill_after_src_prepare(sid, request):
                    result = real(sid, request)
                    if isinstance(request, ShardPrepare) and request.op == "rename_src" \
                            and not killed:
                        killed.append(ring.shards["s0"].kill_leader())
                    return result

                ring.coordinator._shard_submit = kill_after_src_prepare
                t1 = time.perf_counter()
                rf.rename_key_cross("shardv", src, "old", dstb, "new")
                kill_ms = 1e3 * (time.perf_counter() - t1)
                where = [code(lambda: rf.lookup_key("shardv", src, "old")),
                         code(lambda: rf.lookup_key("shardv", dstb, "new"))]
                if not killed or where != ["KEY_NOT_FOUND", None] or \
                        rf.lookup_key("shardv", dstb, "new")["size"] != 21:
                    raise AssertionError(f"shard (f): after the leader kill {where}")
                print(f"shard (f): ommg {ommg_ops} ops (rl, 4 buckets, 8 threads) on 2 "
                      f"shards of 3 replicas in {secs:.3f} s = {rep.ops / rep.elapsed_s:.1f} "
                      f"ops/s, follower reads {hits} hits {misses} misses = {rate:.3f}; "
                      f"leader {killed[0]} killed mid-rename: the rename finished on the "
                      f"new leader in {kill_ms:.1f} ms, the key under its new name only "
                      f"[{card}]")
            finally:
                ring.close()

        # ---- (g) over the RPC: MiniShardedCluster, the CLI, omkg scaling
        cluster = MiniShardedCluster(root / "rpc", n_shards=2, device=device)
        rc = cluster.om_client()
        try:
            rc.create_volume("shardv")
            gb = bucket_on(cluster.map, "s0", "g")
            rc.create_bucket("shardv", gb, replication="RATIS/1")
            for i in range(3):
                s = rc.open_key("shardv", gb, f"k{i}")
                if i == 2:  # the slot moves under an open key
                    cluster.move_slot(slot_for("shardv", gb), "s1")
                rc.commit_key(s, [], i)
            names_rpc = sorted(k["name"] for k in rc.list_keys("shardv", gb))
            on_s1 = sorted(k for k, _ in cluster.daemons["s1"].om.store.iterate("keys"))
            if names_rpc != ["k0", "k1", "k2"] or len(on_s1) != 3:
                raise AssertionError(f"shard (g): {names_rpc} after move_slot, s1 {on_s1}")
            proc = subprocess.run([sys.executable, "-m", "ozone_tpu_torch.tools", "admin",
                                   "shards", "map", "--om", cluster.map.addresses["s0"]],
                                  capture_output=True, text=True, timeout=120,
                                  cwd=str(repo), env=env)
            shown = json.loads(proc.stdout) if proc.returncode == 0 else None
            if not shown or shown["epoch"] != 2 or \
                    shown["slots_per_shard"] != {"s0": 31, "s1": 33}:
                raise AssertionError(f"shard (g): admin shards map: {proc.stdout} "
                                     f"{proc.stderr[-2000:]}")
            print(f"shard (g): MiniShardedCluster(2): a client rode out move_slot under "
                  f"an open key (3 keys, all on s1); admin shards map: {json.dumps(shown)}")
        finally:
            rc.close()
            cluster.shutdown()

        ops_s = {}
        for n in (1, 2, 4):
            p = ShardedMetaPlane(root / f"omkg{n}", n_shards=n, device=device)
            try:
                rep = freon.omkg(p.client(), n_keys=omkg_keys, threads=8,
                                 buckets=max(2 * n, 2))
                if rep.failures:
                    raise AssertionError(f"shard (g): omkg {n} shards: {rep.failures}")
                ops_s[n] = rep.ops / rep.elapsed_s
            finally:
                p.close()

        def spawn(n: int) -> tuple[dict, dict, dict]:
            """n shardd processes over one address book: (book, procs, logs)."""
            book = {f"s{i}": f"127.0.0.1:{port}" for i, port in enumerate(free_ports(n))}
            arg = ",".join(f"{k}={v}" for k, v in book.items())
            logs = {sid: root / f"shardd{n}-{sid}.log" for sid in book}
            procs = {}
            for sid in book:
                with open(logs[sid], "w") as log:
                    procs[sid] = subprocess.Popen(
                        [sys.executable, "-m", "ozone_tpu_torch.tools.shardd", "--base",
                         str(root / f"shardd{n}" / sid), "--shard-id", sid, "--shards",
                         arg], cwd=str(repo), env=env, stdout=log, stderr=log)
            return book, procs, logs

        def ready(book: dict, procs: dict, logs: dict, t0: float) -> list:
            """Seconds from t0 until each shard answers GetShardMap."""
            start_s: dict = {}
            while len(start_s) < len(book):
                for sid, addr in book.items():
                    if sid in start_s:
                        continue
                    if procs[sid].poll() is not None:
                        raise AssertionError(f"shardd {sid} exited {procs[sid].returncode}: "
                                             f"{logs[sid].read_text()[-2000:]}")
                    c = RemoteOmClient(addr, shard_aware=False)
                    try:
                        if c.get_shard_map():
                            start_s[sid] = time.perf_counter() - t0
                    except Exception:
                        pass
                    finally:
                        c.close()
                if time.perf_counter() - t0 > 180:
                    raise AssertionError("shardd processes never became ready")
                time.sleep(0.05)
            return [round(start_s[sid], 3) for sid in sorted(start_s)]

        def stop(procs: dict, logs: dict) -> dict:
            """SIGTERM every process still running; their exit codes."""
            for p in procs.values():
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            rcs = {sid: p.wait(timeout=60) for sid, p in procs.items()}
            return {sid: (rc, logs[sid].read_text()[-1000:] if rc else "")
                    for sid, rc in rcs.items()}

        # both sets and a bare `import torch` (the part of a shardd's start
        # that is not its own) start together; each set is driven alone
        t0 = time.perf_counter()
        sets = {n: spawn(n) for n in (1, 4)}
        probe = subprocess.Popen(
            [sys.executable, "-c", "import time; t = time.perf_counter(); import torch; "
             "print(time.perf_counter() - t, torch.cuda.is_initialized())"],
            stdout=subprocess.PIPE, text=True, env=env)
        proc_ops_s, start, exits = {}, {}, {}
        try:
            for n, (book, procs, logs) in sets.items():
                start[n] = ready(book, procs, logs, t0)
            for n, (book, procs, logs) in sets.items():
                om = RemoteOmClient(",".join(book.values()), shard_aware=True)
                try:
                    rep = freon.omkg(OzoneClient(om, None, device=device),
                                     n_keys=shardd_keys, threads=8, buckets=16)
                finally:
                    om.close()
                if rep.failures:
                    raise AssertionError(f"shard (g): omkg over {n} shardd: {rep.failures}")
                proc_ops_s[n] = rep.ops / rep.elapsed_s
                exits[n] = stop(procs, logs)  # before the next set runs
        finally:
            for n, (_, procs, logs) in sets.items():
                exits.setdefault(n, stop(procs, logs))
            torch_s = float(probe.communicate(timeout=120)[0].split()[0])
        if any(rc for e in exits.values() for rc, _ in e.values()):
            raise AssertionError(f"shard (g): shardd exits {exits}")
        out["omkg_ops_s"], out["shardd_ops_s"] = ops_s, proc_ops_s
        out["shardd_start_s"], out["torch_import_s"] = start, torch_s
        print(f"shard (g): omkg {omkg_keys} keys, 8 threads: in-process "
              + ", ".join(f"{n} shards {v:.1f} ops/s" for n, v in ops_s.items())
              + f" (4/1 = {ops_s[4] / ops_s[1]:.2f}); {shardd_keys} keys over shardd "
              "processes: " + ", ".join(f"{n} {v:.1f} ops/s" for n, v in proc_ops_s.items())
              + f" (4/1 = {proc_ops_s[4] / proc_ops_s[1]:.2f}); os.cpu_count() "
              f"{os.cpu_count()}; shardd start seconds {start} (a bare `import torch` "
              f"{torch_s:.2f} s); every shardd exited 0 on SIGTERM [{card}]")
    return out


def check_prom_text(text: str) -> int:
    """The `/prom` golden rules over a scrape: every `# TYPE` line names a
    stable metric of a known type, follows its `# HELP` line and precedes
    its samples, and every counter of every registry of this process is
    there. Returns the number of metric families."""
    import re

    from ozone_tpu_torch.utils import metrics

    lines = text.splitlines()
    name_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
    seen = set()
    for i, line in enumerate(lines):
        if not line.startswith("# TYPE "):
            continue
        _, _, metric, mtype = line.split(" ")
        if mtype not in ("counter", "gauge", "summary", "histogram") \
                or not name_re.match(metric) \
                or not lines[i - 1].startswith(f"# HELP {metric} ") \
                or not lines[i + 1].startswith(metric):
            raise AssertionError(f"/prom: family {metric} breaks the exposition rules")
        seen.add(metric)
    with metrics._all_lock:
        regs = dict(metrics._all_registries)
    for name, reg in regs.items():
        base = name.replace(".", "_").replace("-", "_")
        for k in list(reg._counters):
            want = f"{base}_{k.replace('.', '_').replace('-', '_')}"
            if want not in seen:
                raise AssertionError(f"/prom: registry {name} lacks {want}")
    return len(seen)


def ops_path(device, cell: int, bpc: int, seed: int, n_keys: int = 8,
             key_cells: int = 64) -> dict:
    """Upgrade finalization and the operator's view (Apache Ozone's
    feature/Nonrolling-Upgrade.md, feature/Observability.md and
    feature/Reconfigurability.md; docs/OPERATIONS.md): an ScmOmDaemon with
    its HTTP server and Recon (tasks every 2 s) and 10 DatanodeDaemons,
    rs-6-3 at `cell` with CRC32C over `bpc`, the metadata services and
    nine datanodes seeded at layout 2, one at 0. (a) `admin upgrade`
    shows the gated features; 4 of the `n_keys` keys of `key_cells`
    cells and odd tails are PUT with every member downgraded to per-chunk
    verbs (counted per member, no native write stream); a snapshot
    create, an aws-chunked S3 PUT and a StreamWriteBlock are refused with
    NOT_SUPPORTED_OPERATION_PRIOR_FINALIZATION and change nothing. (b)
    `admin finalizeupgrade`: seconds until every datanode reports the
    latest layout in the node table and on disk; 4 more keys on the
    batched native lane (GiB/s against (a)'s); the three verbs succeed.
    (c) Recon: `run_tasks_once` seconds, du equal to the bytes written,
    every key's containers mapped, `/api/codec` dispatches equal the
    launch counter's delta, the layouts in `/api/nodes`, a warehouse row
    per task run. (d) A data-unit holder stopped: a degraded GET decodes
    on the card; once it is DEAD, seconds until `/api/containers/
    unhealthy` lists its containers with their missing index, the SCM's
    rebuild (every chunk against the lost one) and seconds until Recon
    reports them healthy. (e) A `/prom` scrape under the golden rules
    (bytes, ms, exemplar trace ids), `/stacks` with the codec dispatcher
    thread, `admin reconfig set ozone.scm.dead.node.interval`. (f)
    `insight list|metrics|log-level|logs` against a datanode, `trace
    slow|show` of a PUT's spans at the collector, `audit top|failures`
    over the OM's audit log. Every key is byte-exact; launches equal the
    codec service's dispatches in every step."""
    import collections
    import urllib.request

    from ozone_tpu_torch.client.native_dn import NativeDatanodeClient
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.gateway.s3 import S3Gateway
    from ozone_tpu_torch.net.dn_service import RpcDatanodeClient
    from ozone_tpu_torch.net.scm_service import RemoteScmClient
    from ozone_tpu_torch.storage.ids import BlockID, StorageError
    from ozone_tpu_torch.tools import cli
    from ozone_tpu_torch.utils import upgrade as ug
    from ozone_tpu_torch.utils.insight import INSIGHT_POINTS
    from ozone_tpu_torch.utils.metrics import registry
    from ozone_tpu_torch.utils.tracing import Tracer

    rs = f"rs-6-3-{cell // 1024}k"
    rng = np.random.default_rng(seed + 21)
    gib = float(1 << 30)
    pre = ug.PRE_FINALIZE_ERROR
    out: dict = {"launches": {}}
    issued: collections.Counter = collections.Counter()
    refused: list[str] = []
    sizes = [key_cells * cell + 12345 * (i + 1) for i in range(n_keys)]
    keys = [rng.integers(0, 256, n, dtype=np.uint8) for n in sizes]
    s0 = service_counts()

    def begin() -> dict:
        fused_kernel.launches.reset()
        return service_counts()

    def end(what: str, key: str, mark: dict, decode: bool = False) -> int:
        launches = fused_kernel.launches.count
        check_launches_equal(what, device, launches, service_delta(mark))
        if device.type == "cuda" and launches <= 0:
            raise AssertionError(f"{what}: no {'decode' if decode else 'encode'} "
                                 "launched")
        out["launches"][key] = out["launches"].get(key, 0) + launches
        return launches

    def cli_text(*argv) -> str:
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
        if rc != 0:
            raise AssertionError(f"CLI {' '.join(argv)} exited {rc}")
        return buf.getvalue()

    def code(fn) -> str | None:
        try:
            fn()
        except StorageError as e:
            return e.code
        return None

    def http_json(addr: str, path: str):
        with urllib.request.urlopen(f"http://{addr}{path}", timeout=30) as r:
            return json.loads(r.read())

    audit_log = logging.getLogger("audit.om")
    layouts = {"meta": 2, **{i: 2 for i in range(9)}, 9: 0}
    meta_kw = {"http_port": 0, "recon_port": 0, "recon_interval_s": 2.0}
    with codec_route(True), \
            tempfile.TemporaryDirectory(prefix="chip-smoke-ops-audit-") as tmp, \
            daemon_cluster(device, 10, cell, seed, "ops", layouts=layouts,
                           meta_kw=meta_kw) as (meta, dns, oz):
        root = Path(tmp)
        handler = logging.FileHandler(root / "om-audit.log")
        old_level = audit_log.level
        audit_log.addHandler(handler)
        audit_log.setLevel(logging.INFO)
        scm = RemoteScmClient(meta.address)
        gw = None
        dn0 = RpcDatanodeClient(dns[0].dn.id, dns[0].address)
        try:
            addr = meta.address
            by_id = {d.dn.id: d for d in dns}

            # (a) before finalization
            st = cli_json("admin", "upgrade", "--om", addr)
            gated = [f["name"] for f in st["features"] if not f["allowed"]]
            if not st["needs_finalization"] or st["metadata_version"] != 2 or \
                    gated != ["BUCKET_SNAPSHOTS", "S3_CHUNKED_UPLOAD",
                              "RATIS_STREAMING_WRITE"]:
                raise AssertionError(f"admin upgrade before finalization: {st}")
            want = [2] * 9 + [0]
            if [d.layout.metadata_version for d in dns] != want:
                raise AssertionError("datanode layouts differ from the seeded ones")
            wait_for("the seeded layouts in the node table", lambda: sorted(
                (n["dn_id"], n["layout_version"]) for n in scm.status()["nodes"])
                == [(f"dn{i}", v) for i, v in enumerate(want)], 30)
            vol = oz.create_volume("opsv")
            b = vol.create_bucket("ec", replication=rs)
            issued.update(["CreateVolume", "CreateBucket"])
            ids = [d.dn.id for d in dns]

            def member_downgrades() -> dict:
                out_ = {}
                for dn_id in ids:
                    c = oz.clients.maybe_get(dn_id)
                    if isinstance(c, NativeDatanodeClient):
                        out_[dn_id] = c.layout_downgrades
                return out_

            batch = registry("ec.writer").counter("batch_downgrades")

            def put(idx: list[int], what: str, key: str) -> dict:
                d0, b0 = member_downgrades(), batch.value
                mark = begin()
                t0 = time.perf_counter()
                with LaneMeter(dns) as m:
                    concurrent(lambda i: b.write_key(f"k{i}", keys[i]), idx)
                secs = time.perf_counter() - t0
                issued.update(["OpenKey", "CommitKey"] * len(idx))
                launches = end(what, key, mark)
                d1 = member_downgrades()
                per = {dn: d1.get(dn, 0) - d0.get(dn, 0) for dn in ids}
                nbytes = sum(sizes[i] for i in idx)
                rate = nbytes / secs / gib
                print(f"{what}: {len(idx)} keys, {nbytes} B in {secs:.3f} s = "
                      f"{rate:.3f} GiB/s (wall); launches {launches}; batched-verb "
                      f"refusals {batch.value - b0}; native-lane refusals per member "
                      f"{per}; {m.line('batched_write_chunks')}")
                return {"gib_s": rate, "per_member": per, "lane": m.d,
                        "batch_refusals": batch.value - b0}

            pre_put = put(list(range(n_keys // 2)), "ops PUT before finalization",
                          "ops_put_pre_finalize")
            touched = {dn for i in range(n_keys // 2)
                       for g in oz.om.lookup_key("opsv", "ec", f"k{i}")["block_groups"]
                       for dn in g["nodes"]}
            if pre_put["lane"]["native_write_streams"] != 0 or any(
                    pre_put["per_member"][dn] <= 0 for dn in touched) or \
                    pre_put["batch_refusals"] < n_keys // 2:
                raise AssertionError("before finalization every member must downgrade "
                                     f"(counted) and no native write stream land: {pre_put}")
            # the three gated verbs are refused and change nothing
            refused.append("CreateSnapshot")
            if code(lambda: oz.om.create_snapshot("opsv", "ec", "s1")) != pre or \
                    oz.om.list_snapshots("opsv", "ec"):
                raise AssertionError("snapshot create was not refused before finalization")
            gw = S3Gateway(oz, replication=rs)
            gw.upgrade_cache_ttl_s = 0.0
            gw.start()
            issued["CreateVolume"] += 1  # the gateway's s3v
            secret = meta.om.get_s3_secret("ops")
            issued["SetS3Secret"] += 1
            s3 = S3Client(gw.address, "ops", secret)
            s3.ok("PUT", "/opsb")
            issued["CreateBucket"] += 1
            chunked = rng.integers(0, 256, 3 * cell + 777, dtype=np.uint8).tobytes()
            st_, _, _ = s3.req("PUT", "/opsb/chunked", chunked, streaming=True)
            st_get, _, _ = s3.req("GET", "/opsb/chunked")
            if st_ != 501 or st_get != 404:
                raise AssertionError(f"aws-chunked PUT before finalization: {st_}, then "
                                     f"GET {st_get}")
            dn0.create_container(10 ** 6)
            if code(lambda: dn0.stream_write_block(BlockID(10 ** 6, 1), [b"x" * 4096])) \
                    != pre or code(lambda: dn0.get_block(BlockID(10 ** 6, 1))) is None:
                raise AssertionError("StreamWriteBlock was not refused before finalization")
            print(f"ops refusals before finalization: snapshot create, aws-chunked PUT "
                  f"(HTTP {st_}), StreamWriteBlock all {pre}; nothing written")
            mark = begin()
            got = concurrent(lambda i: b.read_key(f"k{i}"), list(range(n_keys // 2)))
            if not all(np.array_equal(g, keys[i]) for i, g in enumerate(got)):
                raise AssertionError("ops GET before finalization: bytes differ")
            del got
            check_launches_equal("ops GET before finalization", device,
                                 fused_kernel.launches.count, service_delta(mark))

            # (b) finalization
            t0 = time.perf_counter()
            fin = cli_json("admin", "finalizeupgrade", "--om", addr)
            if fin != {"scm": "FINALIZATION_DONE", "datanodes_notified": 10}:
                raise AssertionError(f"admin finalizeupgrade: {fin}")
            latest = ug.LATEST_VERSION

            def finalized() -> bool:
                return all(n["layout_version"] == latest
                           for n in scm.status()["nodes"]) and all(
                    json.loads((d.dn.root / "layout_version.json").read_text()
                               )["layout_version"] == latest for d in dns)

            fin_s = wait_for("every datanode finalized", finalized, 60, poll_s=0.05)
            fin_s = time.perf_counter() - t0
            post_put = put(list(range(n_keys // 2, n_keys)), "ops PUT after finalization",
                           "ops_put_post_finalize")
            if post_put["lane"]["native_write_streams"] <= 0 or \
                    any(post_put["per_member"].values()) or post_put["batch_refusals"]:
                raise AssertionError(f"after finalization the native lane must carry "
                                     f"the writes, with no refusal: {post_put}")
            print(f"ops finalize: every datanode at layout {latest} in the node table and "
                  f"on disk {fin_s:.3f} s after `admin finalizeupgrade`; PUT "
                  f"{pre_put['gib_s']:.3f} GiB/s before (per-chunk verbs) against "
                  f"{post_put['gib_s']:.3f} GiB/s after (native batched lane)")
            out.update(finalize_s=fin_s, put_gib_s_before=pre_put["gib_s"],
                       put_gib_s_after=post_put["gib_s"])
            oz.om.create_snapshot("opsv", "ec", "s1")
            issued["CreateSnapshot"] += 1
            mark = begin()
            s3.ok("PUT", "/opsb/chunked", chunked, streaming=True)
            issued.update(["OpenKey", "CommitKey"])
            if s3.ok("GET", "/opsb/chunked")[1] != chunked:
                raise AssertionError("aws-chunked object differs")
            end("ops aws-chunked PUT after finalization", "ops_s3_chunked", mark)
            if dn0.stream_write_block(BlockID(10 ** 6, 1), [b"x" * 4096]).length != 4096:
                raise AssertionError("StreamWriteBlock after finalization")
            print("ops after finalization: snapshot s1 created, aws-chunked PUT and GET "
                  "byte-exact, StreamWriteBlock committed 4096 B")

            # (c) Recon
            recon = meta.recon
            t0 = time.perf_counter()
            recon.run_tasks_once()
            out["recon_tasks_s"] = time.perf_counter() - t0
            ra = recon.address
            du = http_json(ra, "/api/nssummary?path=/opsv/ec")
            if (du["total_files"], du["total_bytes"]) != (n_keys, sum(sizes)):
                raise AssertionError(f"Recon du {du} != {n_keys} keys of {sum(sizes)} B")
            ck = http_json(ra, "/api/containers/keys")
            for i in range(n_keys):
                for g in oz.om.lookup_key("opsv", "ec", f"k{i}")["block_groups"]:
                    if f"/opsv/ec/k{i}" not in ck.get(str(g["container_id"]), []):
                        raise AssertionError(f"Recon does not map k{i} to container "
                                             f"{g['container_id']}")
            for _ in range(5):  # read between two equal launch totals
                l0 = fused_kernel.launches.total
                cx = http_json(ra, "/api/codec")
                if fused_kernel.launches.total == l0:
                    break
            launched = l0 - s0["launches_total"]
            if device.type == "cuda" and cx["dispatches"] - s0["dispatches"] != launched:
                raise AssertionError(f"/api/codec dispatches {cx['dispatches']} - "
                                     f"{s0['dispatches']} != launches {launched}")
            nodes = http_json(ra, "/api/nodes")
            if sorted(n["layout_version"] for n in nodes) != [latest] * 10:
                raise AssertionError(f"/api/nodes layouts {nodes}")
            kinds = ("namespace", "filesizes", "container_health", "nodes",
                     "table_counts")
            rows = wait_for("a warehouse row per task run", lambda: len(
                {len(recon.warehouse.history(k, 1000)) for k in kinds}) == 1, 10)
            runs = len(recon.warehouse.history("namespace", 1000))
            print(f"ops Recon: run_tasks_once {out['recon_tasks_s']:.3f} s; du "
                  f"{du['total_bytes']} B in {du['total_files']} keys; every key's "
                  f"containers mapped; /api/codec dispatches since the phase began "
                  f"{cx['dispatches'] - s0['dispatches']} = kernel launches {launched}; "
                  f"/api/nodes layouts all {latest}; {runs} task runs, one warehouse row "
                  f"each of {len(kinds)} kinds ({rows:.2f} s wait)")

            # (d) a datanode stopped: degraded GET, Recon's view, the rebuild
            for c in scm.list_containers():
                if c["id"] != 10 ** 6:
                    scm.admin("close-container", str(c["id"]))
            wait_for("containers closed", lambda: all(
                c["state"] == "CLOSED" and all(r["state"] == "CLOSED" for r in c["replicas"])
                for c in scm.list_containers()), 60)
            info0 = oz.om.lookup_key("opsv", "ec", "k0")
            victim = info0["block_groups"][0]["nodes"][0]
            vdn = by_id[victim].dn
            vcont = {c.id: c.replica_index for c in vdn.list_containers()
                     if c.replica_index > 0}
            stop_server(by_id[victim])
            mark = begin()
            t0 = time.perf_counter()
            got = b.read_key("k0")
            deg_s = time.perf_counter() - t0
            if not np.array_equal(got, keys[0]):
                raise AssertionError("ops degraded GET: bytes differ")
            del got
            end("ops degraded GET", "ops_degraded_get", mark, decode=True)
            print(f"ops degraded GET ({victim} down): {sizes[0]} B byte-exact in "
                  f"{deg_s:.3f} s = {sizes[0] / deg_s / gib:.3f} GiB/s (wall)")

            def unhealthy_listed() -> bool:
                rows_ = {r["container"]: r for r in
                         http_json(ra, "/api/containers/unhealthy")}
                return all(idx in rows_.get(cid, {}).get("missing_indexes", [])
                           for cid, idx in vcont.items())

            t_dead = [0.0]

            def on_dead():
                t_dead[0] = time.perf_counter()
                out["recon_unhealthy_s"] = wait_for(
                    "Recon lists the dead node's containers", unhealthy_listed, 30,
                    poll_s=0.02)

            rep = repair_onto_spare(meta, dns, by_id, victim, device, bpc,
                                    "ops repair", "by the SCM's commands",
                                    on_dead=on_dead)
            out["launches"]["ops_repair"] = rep["launches"]

            def healthy() -> bool:
                h = http_json(ra, "/api/containers/health")
                return all(cid in h["healthy"] for cid in vcont)

            wait_for("Recon reports the rebuilt containers healthy", healthy, 60,
                     poll_s=0.05)
            out["recon_healthy_s"] = time.perf_counter() - t_dead[0]
            print(f"ops Recon over the repair: {sorted(vcont)} listed unhealthy with "
                  f"their missing index {out['recon_unhealthy_s']:.3f} s after {victim} "
                  f"was DEAD; rebuilt in {rep['seconds']:.3f} s; healthy in Recon "
                  f"{out['recon_healthy_s']:.3f} s after the death")

            # (e) HTTP: /prom, /stacks, /reconfig
            ha = meta.http.address
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"http://{ha}/prom", timeout=30) as r:
                prom = r.read().decode()
            prom_ms = 1e3 * (time.perf_counter() - t0)
            fams = check_prom_text(prom)
            exemplars = sum(1 for ln in prom.splitlines() if ' # {trace_id="' in ln)
            if not exemplars:
                raise AssertionError("/prom: no exemplar trace id")
            with urllib.request.urlopen(f"http://{ha}/stacks", timeout=30) as r:
                stacks = r.read().decode()
            if 'Thread "codec-service"' not in stacks:
                raise AssertionError("/stacks does not list the codec dispatcher thread")
            rc_ = cli_json("admin", "reconfig", "set", "ozone.scm.dead.node.interval",
                           "--value", "120", "--http", ha)
            if rc_["new"] != 120.0 or meta.scm.nodes.dead_after != 120.0:
                raise AssertionError(f"live reconfiguration: {rc_}")
            out.update(prom_bytes=len(prom), prom_ms=prom_ms)
            print(f"ops HTTP: /prom {len(prom)} B in {prom_ms:.2f} ms, {fams} families "
                  f"under the golden rules, {exemplars} exemplar trace ids; /stacks "
                  f"lists codec-service; reconfig ozone.scm.dead.node.interval "
                  f"{rc_['old']} -> {rc_['new']} s, the node manager reads "
                  f"{meta.scm.nodes.dead_after}")

            # (f) insight, trace, audit
            d1 = next(d for d in dns if d.dn.id != victim)
            pts = cli_json("insight", "list", "--address", d1.address)
            mx = cli_json("insight", "metrics", "--address", d1.address)
            reg = mx["registries"].get(f"datanode.{d1.dn.id}", {})
            if set(pts["points"]) != set(INSIGHT_POINTS) or \
                    reg.get("bytes_written", 0) <= 0:
                raise AssertionError(f"insight against {d1.dn.id}: {pts['component']}, "
                                     f"{reg}")
            cli_json("insight", "log-level", "--address", d1.address, "--logger",
                     "ozone_tpu_torch.utils.http_server", "--level", "DEBUG")
            http_json(ra, "/api/summary")
            logs = cli_text("insight", "logs", "--address", d1.address, "--logger",
                            "ozone_tpu_torch.utils.http_server", "--level", "DEBUG",
                            "-n", "20")
            cli_json("insight", "log-level", "--address", d1.address, "--logger",
                     "ozone_tpu_torch.utils.http_server", "--level", "NOTSET")
            if "/api/summary" not in logs:
                raise AssertionError(f"insight logs after SetLogLevel DEBUG: {logs!r}")
            with env_set(OZONE_TPU_TRACE_SLO_CLIENT_PUT_MS="0"):
                small = rng.integers(0, 256, 2 * cell + 7, dtype=np.uint8)
                mark = begin()
                b.write_key("traced", small)
                issued.update(["OpenKey", "CommitKey"])
                end("ops traced PUT", "ops_traced_put", mark)
                tid = next(t["traceId"] for t in Tracer.instance().recorder.slow(10)
                           if t["root"] == "client:put")

                def assembled() -> bool:
                    for d in dns:
                        d.trace_exporter.flush()
                    names = {sp["name"] for sp in meta.trace_collector.trace(tid)}
                    return "client:put" in names and any(
                        "DatanodeService" in n and n.startswith("server:") for n in names)

                trace_s = wait_for("the PUT's trace at the collector", assembled, 60,
                                   poll_s=0.2)
            spans = meta.trace_collector.trace(tid)
            slow = cli_json("trace", "slow", "--om", addr)
            shown = cli_text("trace", "show", tid, "--om", addr)
            if tid not in {t["traceId"] for t in slow} or "critical path:" not in shown:
                raise AssertionError(f"trace {tid} not retained by the collector")
            stages = [ln.split()[0] for ln in shown.splitlines()[2:]]
            print(f"ops trace {tid}: {len(spans)} spans at the collector ({trace_s:.2f} s), "
                  f"client and datanode under one id; critical path stages {stages}")
            handler.flush()
            top = {r["action"]: r["count"] for r in
                   cli_json("audit", "top", str(root / "om-audit.log"), "-n", "100")}
            fails = cli_json("audit", "failures", str(root / "om-audit.log"), "-n", "100")
            total = collections.Counter(issued)
            total.update(refused)
            if top != dict(total) or [(r["action"], r.get("error")) for r in fails] != \
                    [(a, pre) for a in refused]:
                raise AssertionError(f"audit: {top} != issued {dict(total)}, failures "
                                     f"{fails}")
            print(f"ops audit: {sum(top.values())} records, by action {top}; failures "
                  f"{[(r['action'], r['error']) for r in fails]}")
            out["audit"] = top
        finally:
            audit_log.removeHandler(handler)
            audit_log.setLevel(old_level)
            handler.close()
            dn0.close()
            if gw is not None:
                gw.stop()
            scm.close()
    return out


def chaos_path(device, cell: int, bpc: int, seed: int, n_keys: int = 8,
               key_cells: int = 64, chaos_s: float = 20.0, n_freon: int = 32,
               om_scale_keys: int = 100_000, dnsim_nodes: int = 50) -> dict:
    """Fault injection and the operator's repair tools (Apache Ozone's
    hadoop-ozone/fault-injection-test: mini-chaos-tests, the network-tests
    blockade suites, fault-injection-service and the dev-support/byteman
    verb rules; docs/OPERATIONS.md), rs-6-3 at `cell` with CRC32C over
    `bpc`. (a) `run_chaos` on a 12-datanode MiniOzoneCluster, max_down 3,
    the reference's 0.3 s interval, keys of 6 cells and 4 KiB written for
    `chaos_s` seconds: every committed key byte-exact. (c) Three metadata
    daemons in one process: an owner-scoped block cuts the leader's raft
    channels; seconds to a new leader, 2 PUTs through it, the old leader
    rejoins as a follower after the heal. On an ScmOmDaemon and 10
    DatanodeDaemons: (b) `n_keys` keys of `key_cells` cells and odd
    tails; one datanode partitioned (PUTs exclude it, a GET decodes on the
    card); one member delayed 0.5 s (a GET hedges and decodes); a verb
    rule failing the first 3 WriteChunksCommit calls to one member, on the
    native lane and then the RPC lane; `insight partition|partitions|heal`
    through the CLI; the OM's admission with OPS_OM=4, BURST_S=0.5. (f)
    freon rawcoder on the card, dcg/dcb/dcv/dnbp on each lane, ralg, hsg,
    sdg, scmtb, cmdw, dbgen and om_scale at `om_scale_keys` keys. (d) A
    `datanode` process under the LD_PRELOAD injector: writes to its
    containers fail with EIO (PUTs exclude it on both lanes), then its
    writes are corrupted; its scanner (the scrub form, on the card in that
    process) marks the replicas UNHEALTHY, the SCM rebuilds them by
    decoding here, every rebuilt unit equals the numpy coder's; offline
    `debug container-inspect` of its root lists the scan errors. (e) One
    datanode stopped: `fsck` DEGRADED for exactly the keys with a unit
    there; after the SCM's rebuild, all HEALTHY; `debug verify-replicas`
    and `chunk-info`, `repair orphans` (and --delete), `debug
    export-container` / `import-container`, `repair quota`, `repair
    transaction` on a copy of the OM db; the metadata daemon restarted,
    `admin safemode` shows the pipeline rules passing before the first
    allocation; then `freon dnsim`. Launches equal the codec service's
    dispatches in every step but the process's own scrub."""
    import collections
    import io
    import itertools
    import sqlite3

    from ozone_tpu_torch import admission
    from ozone_tpu_torch.client import resilience
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader
    from ozone_tpu_torch.client.ec_writer import (
        BlockGroup,
        ECKeyWriter,
        block_lengths,
    )
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.scm.pipeline import Pipeline, ReplicationConfig
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.codec import fused_kernel, torch_coder
    from ozone_tpu_torch.net import partition
    from ozone_tpu_torch.net.daemons import ScmOmDaemon
    from ozone_tpu_torch.net.dn_service import RpcDatanodeClient
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.net.scm_service import RemoteScmClient
    from ozone_tpu_torch.storage import container_packer as cp
    from ozone_tpu_torch.storage.ids import BlockID, StorageError
    from ozone_tpu_torch.testing.chaos import run_chaos
    from ozone_tpu_torch.testing.fault_injection import FaultInjector, build_injector
    from ozone_tpu_torch.testing.minicluster import (
        MiniOzoneCluster,
        MiniOzoneHACluster,
        await_meta_leader,
    )
    from ozone_tpu_torch.tools import cli, om_scale
    from ozone_tpu_torch.utils.metrics import registry

    rs = f"rs-6-3-{cell // 1024}k"
    gib = float(1 << 30)
    rng = np.random.default_rng(seed + 22)
    small = 6 * cell + 4096  # one full stripe and a tail
    dev = device.type
    out: dict = {"launches": {}}

    def begin() -> dict:
        fused_kernel.launches.reset()
        return service_counts()

    def end(what: str, key: str, mark: dict, need: bool = True) -> int:
        launches = fused_kernel.launches.count
        check_launches_equal(what, device, launches, service_delta(mark))
        if need and device.type == "cuda" and launches <= 0:
            raise AssertionError(f"{what}: nothing launched")
        out["launches"][key] = out["launches"].get(key, 0) + launches
        return launches

    def key_nodes(om, vol, bkt, name) -> set:
        return {n for g in om.lookup_key(vol, bkt, name)["block_groups"]
                for n in g["nodes"]}

    # ---- (a) chaos on a MiniOzoneCluster
    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-chaos-") as tmp:
        cl = MiniOzoneCluster(Path(tmp), num_datanodes=12, block_size=16 * cell,
                              container_size=4096 * cell, stale_after_s=1000.0,
                              dead_after_s=2000.0, placement_seed=seed, device=device)
        try:
            mark = begin()
            t0 = time.perf_counter()
            res = run_chaos(cl, duration_s=chaos_s, replication=rs, key_size=small,
                            max_down=3, seed=seed, interval_s=0.3, device=device)
            secs = time.perf_counter() - t0
            end("chaos (a) PUTs under kills and the read-back", "chaos_run", mark)
        finally:
            cl.close()
    n_ok = len(res.keys_written)
    print(f"chaos (a): {n_ok} keys of {small} B committed in {chaos_s:.0f} s of writes "
          f"({n_ok * small / chaos_s / MIB:.1f} MiB/s), {res.write_failures} write "
          f"failures, {res.kills} kills, {res.restarts} restarts (max 3 down, every "
          f"0.3 s); read-back {secs - chaos_s:.3f} s: mismatches {res.read_mismatches}, "
          f"errors {res.read_errors[:3]}")
    if res.read_mismatches or res.read_errors or res.kills < 1 or n_ok < 3:
        raise AssertionError("chaos (a): a committed key is not byte-exact, or the run "
                             "killed nothing or wrote too little")
    out["a"] = {"keys": n_ok, "write_failures": res.write_failures, "kills": res.kills,
                "restarts": res.restarts}

    # ---- (c) leader isolation on a metadata ring
    old_period = os.environ.get("OZONE_TPU_LIFECYCLE_PERIOD_S")
    os.environ["OZONE_TPU_LIFECYCLE_PERIOD_S"] = "1e9"
    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-chaos-ha-") as tmp:
        try:
            ring = MiniOzoneHACluster(
                Path(tmp), num_meta=3, num_datanodes=9, block_size=16 * cell,
                heartbeat_interval_s=0.5, device=device, container_size=4096 * cell,
                stale_after_s=30.0, dead_after_s=60.0, background_interval_s=0.5,
                placement_seed=seed)
        finally:
            if old_period is None:
                os.environ.pop("OZONE_TPU_LIFECYCLE_PERIOD_S")
            else:
                os.environ["OZONE_TPU_LIFECYCLE_PERIOD_S"] = old_period
        f = DatanodeClientFactory()
        om = None
        try:
            wait_for("9 datanodes on the ring's leader", lambda: len(
                ring.metas[ring.await_leader()].scm.nodes.nodes()) == 9, 30)
            old = ring.await_leader()
            followers = [m for m in ring.metas if m != old]
            # the client dials the majority only: the isolated replica would
            # hold a write for its whole ack timeout
            om = RemoteOmClient(",".join(ring.peers[m] for m in followers), clients=f)
            oz = OzoneClient(om, f, device=device)
            t0 = time.perf_counter()
            for m in followers:
                partition.block(ring.peers[old], owner=m)  # m -> old
                partition.block(ring.peers[m], owner=old)  # old -> m
            new = await_meta_leader(ring.metas, timeout=30.0, among=followers)
            elect_s = time.perf_counter() - t0
            retried = 0

            def once(fn, *a):
                nonlocal retried
                for attempt in range(3):
                    try:
                        return fn(*a)
                    except Exception as e:  # noqa: BLE001 - counted, written again
                        if getattr(e, "code", "").endswith("_ALREADY_EXISTS"):
                            print(f"chaos (c): {fn.__name__}{a[:2]} found its first "
                                  "attempt committed")
                            return None
                        if attempt == 2:
                            raise
                        retried += 1
                        print(f"chaos (c): {fn.__name__}{a[:2]} written again after {e!r}")

            once(oz.om.create_volume, "iso")
            once(oz.om.create_bucket, "iso", "ec", rs)
            b = oz.get_volume("iso").get_bucket("ec")
            datas = [rng.integers(0, 256, small, dtype=np.uint8) for _ in range(2)]
            mark = begin()
            for i, d in enumerate(datas):
                once(b.write_key, f"k{i}", d)
            for i, d in enumerate(datas):
                if not np.array_equal(b.read_key(f"k{i}"), d):
                    raise AssertionError(f"chaos (c): k{i} differs")
            end("chaos (c) PUTs through the new leader", "chaos_isolation_put", mark)
            partition.clear()
            t0 = time.perf_counter()
            rejoin_s = wait_for("the old leader rejoins as a follower", lambda: (
                not ring.metas[old].ha.is_leader and ring.metas[old].om.store.get(
                    "volumes", "/iso") is not None), 60, poll_s=0.05)
            await_meta_leader(ring.metas, timeout=15.0)
            print(f"chaos (c): {old} isolated (owner-scoped blocks both ways): {new} "
                  f"elected {elect_s:.3f} s after the cut; 2 PUTs of {small} B through "
                  f"it byte-exact; healed, {old} a follower holding the volume "
                  f"{rejoin_s:.3f} s later; keys written again after a failed attempt: "
                  f"{retried}; {elections(ring)}")
            out["c"] = {"elect_s": elect_s, "rejoin_s": rejoin_s, "retried": retried}
        finally:
            partition.clear()
            if om is not None:
                om.close()
            f.close()
            ring.shutdown()

    # ---- (b), (f), (d), (e) on one daemon cluster
    sizes = [key_cells * cell + 12345 * (i + 1) for i in range(n_keys)]
    keys = [rng.integers(0, 256, n, dtype=np.uint8) for n in sizes]
    repo = Path(__file__).resolve().parent
    with codec_route(True), \
            tempfile.TemporaryDirectory(prefix="chip-smoke-chaos-dn-") as tmpd, \
            daemon_cluster(device, 10, cell, seed, "chaos") as (meta, dns, oz):
        tmp = Path(tmpd)
        addr = meta.address
        by_id = {d.dn.id: d for d in dns}
        scm = RemoteScmClient(addr)
        rpc_f = DatanodeClientFactory(native_datapath=False)
        rpc_oz = OzoneClient(RemoteOmClient(addr, clients=rpc_f), rpc_f, device=device)
        proc = None
        fi = None
        written: dict[str, np.ndarray] = {}
        try:
            vol = oz.create_volume("chaos")
            b = vol.create_bucket("ec", replication=rs)
            rb = rpc_oz.get_volume("chaos").get_bucket("ec")

            def put(bucket, name, data):
                bucket.write_key(name, data)
                written[name] = data

            # (b) the keys
            mark = begin()
            t0 = time.perf_counter()
            concurrent(lambda i: put(b, f"k{i}", keys[i]), list(range(n_keys)))
            secs = time.perf_counter() - t0
            end("chaos (b) PUT", "chaos_put", mark)
            print(f"chaos (b): {n_keys} keys, {sum(sizes)} B in {secs:.3f} s = "
                  f"{sum(sizes) / secs / gib:.3f} GiB/s (wall)")
            mark = begin()
            t0 = time.perf_counter()
            if not np.array_equal(b.read_key("k1"), keys[1]):
                raise AssertionError("chaos (b): k1 differs")
            get_s = time.perf_counter() - t0
            end("chaos (b) GET", "chaos_get", mark, need=False)

            # a datanode partitioned: PUTs exclude it, a GET decodes
            victim = oz.om.lookup_key("chaos", "ec", "k0")["block_groups"][0]["nodes"][0]
            partition.block(by_id[victim].address)
            try:
                mark = begin()
                for i in range(2):
                    put(b, f"part{i}", rng.integers(0, 256, small, dtype=np.uint8))
                    if victim in key_nodes(oz.om, "chaos", "ec", f"part{i}"):
                        raise AssertionError(f"chaos (b): part{i} placed on {victim}")
                end("chaos (b) PUTs past a partition", "chaos_partition_put", mark)
                mark = begin()
                t0 = time.perf_counter()
                if not np.array_equal(b.read_key("k0"), keys[0]):
                    raise AssertionError("chaos (b): k0 differs past the partition")
                part_get_s = time.perf_counter() - t0
                dec = end("chaos (b) GET past a partition", "chaos_partition_get", mark)
            finally:
                partition.heal(by_id[victim].address)
            print(f"chaos (b): {victim} partitioned: 2 PUTs placed around it; GET of k0 "
                  f"({sizes[0]} B, a unit there) byte-exact in {part_get_s:.3f} s with "
                  f"{dec} decode launches")

            # one member's chunk reads delayed 0.5 s (verb rules on both read
            # verbs; its GetBlock answers at once, so its latency estimate
            # stays low): the GET hedges and decodes from parity
            slow = oz.om.lookup_key("chaos", "ec", "k1")["block_groups"][0]["nodes"][1]
            slow_rules = [partition.add_rule(dst=by_id[slow].address, verb=v,
                                             delay_s=0.5)
                          for v in ("ReadChunks", "ReadChunk")]
            # a fresh latency history: each peer's hedge delay is the floor,
            # not what the partition steps before left in its estimate
            oz.clients.health = resilience.HealthRegistry()
            try:
                mark = begin()
                t0 = time.perf_counter()
                if not np.array_equal(b.read_key("k1"), keys[1]):
                    raise AssertionError("chaos (b): k1 differs under the delay")
                slow_s = time.perf_counter() - t0
                hedged = service_delta(mark)["dispatches"]
                dec = end("chaos (b) GET with a member delayed", "chaos_delay_get", mark)
                if hedged < 1:
                    raise AssertionError("chaos (b): the delayed GET never decoded")
            finally:
                for r in slow_rules:
                    partition.remove_rule(r)
            print(f"chaos (b): {slow}'s chunk reads delayed 0.5 s: GET of k1 ({sizes[1]} B) "
                  f"byte-exact in {slow_s:.3f} s (hedged: {hedged} decode dispatches, {dec} "
                  f"launches) against "
                  f"{get_s:.3f} s with no delay")
            out["b"] = {"get_s": get_s, "delayed_get_s": slow_s,
                        "partitioned_get_s": part_get_s}

            # a verb rule: the first 3 WriteChunksCommit calls to one member fail
            member = next(d.dn.id for d in dns if d.dn.id not in (victim, slow))
            rid = partition.add_rule(dst=by_id[member].address, verb="WriteChunksCommit",
                                     drop_pct=100, count=3)

            def left() -> int:
                r = [x for x in partition.rules() if x["id"] == rid]
                return r[0]["count"] if r else 0

            drops = {"native": 0, "RPC": 0}
            try:
                mark = begin()
                for lane, bucket, stop_at in (("native", b, 1), ("RPC", rb, 0)):
                    for i in range(12):
                        if left() <= stop_at:
                            break
                        before = left()
                        name = f"rule-{lane}-{i}"
                        put(bucket, name, rng.integers(0, 256, small, dtype=np.uint8))
                        drops[lane] += before - left()
                        if before != left() and member in key_nodes(
                                oz.om, "chaos", "ec", name):
                            raise AssertionError(f"chaos (b): {name} kept {member}")
                end("chaos (b) PUTs under the verb rule", "chaos_rule_put", mark)
            finally:
                partition.remove_rule(rid)
            print(f"chaos (b): WriteChunksCommit to {member} dropped {drops} times by "
                  f"lane (rule count 3); every writer excluded it and committed; rule "
                  f"expired: {all(x['id'] != rid for x in partition.rules())}")
            if sum(drops.values()) != 3 or min(drops.values()) < 1:
                raise AssertionError(f"chaos (b): the rule dropped {drops}")

            # the same through the CLI against a datanode's own RPC server
            target = dns[-1]
            got = cli_json("insight", "partition", "--address", dns[0].address,
                           "--dst", target.address)
            listed = cli_json("insight", "partitions", "--address", dns[0].address)
            mark = begin()
            put(b, "cli-part", rng.integers(0, 256, small, dtype=np.uint8))
            end("chaos (b) PUT past a CLI partition", "chaos_cli_partition_put", mark)
            placed = target.dn.id in key_nodes(oz.om, "chaos", "ec", "cli-part")
            healed = cli_json("insight", "heal", "--address", dns[0].address,
                              "--dst", target.address)
            after = cli_json("insight", "partitions", "--address", dns[0].address)
            print(f"chaos (b): insight partition -> {got}; partitions -> {listed}; a PUT "
                  f"placed on {target.dn.id}: {placed}; heal -> {healed}; partitions -> "
                  f"{after}")
            if placed or ["*", target.address] not in listed["blocked"] or \
                    after["blocked"]:
                raise AssertionError("chaos (b): the CLI partition did not cut the link")
            partition.clear()

            # admission at the OM's front door
            m = registry("admission")
            rej0 = m.counter("om_rejected_ops").value
            busy0 = resilience.METRICS.counter("server_busy").value
            try:
                with env_set(OZONE_TPU_ADMIT_OPS_OM="4", OZONE_TPU_ADMIT_BURST_S="0.5"):
                    admission.reset_for_tests()
                    t0 = time.perf_counter()
                    for _ in range(8):
                        oz.om.list_volumes()
                    adm_s = time.perf_counter() - t0
            finally:
                admission.reset_for_tests()
            rej = m.counter("om_rejected_ops").value - rej0
            busy = resilience.METRICS.counter("server_busy").value - busy0
            print(f"chaos (b): 8 unpaced list_volumes with OPS_OM=4, BURST_S=0.5 all "
                  f"succeeded in {adm_s:.3f} s; admission.om_rejected_ops +{rej}, "
                  f"resilience.server_busy +{busy}")
            if rej <= 0 or busy <= 0:
                raise AssertionError("chaos (b): the OM's bucket never refused")

            # ---- (f) the rest of freon, and om_scale
            fr: dict = {}
            apply0 = torch_coder.apply_launches.count
            fused_kernel.launches.reset()
            rows = cli_json("freon", "rawcoder", "--schema", "rs-6-3", "--cell",
                            str(cell), "--batch", "8", "--device", dev)
            raw_launches = fused_kernel.launches.count
            calls = torch_coder.apply_launches.count - apply0
            out["launches"]["chaos_rawcoder"] = raw_launches
            for r in rows:
                if "error" in r:
                    raise AssertionError(f"freon rawcoder: {r}")
            fr["rawcoder"] = {r["backend"]: (r["encode_gib_s"], r["decode_gib_s"])
                              for r in rows}
            print(f"chaos (f) freon rawcoder rs-6-3 B=8 cell={cell}: " + ", ".join(
                f"{be} encode {e:.3f} / decode {d:.3f} GiB/s"
                for be, (e, d) in fr["rawcoder"].items())
                + f"; kernel launches {raw_launches} for the torch coder's {calls} calls "
                "(the SPI launches directly, not through the codec service)")
            if device.type == "cuda" and (raw_launches != calls or calls != 12):
                raise AssertionError("freon rawcoder: launches differ from the torch "
                                     "coder's calls")
            size = str(cell)
            for lane, native in (("native", "1"), ("RPC", "0")):
                with env_set(OZONE_TPU_NATIVE_DATAPATH=native):
                    for gen in ("dcg", "dcv", "dcb", "dnbp"):
                        rep = cli_json("freon", gen, "-n", str(n_freon), "-s", size,
                                       "--om", addr)
                        if rep["failures"]:
                            raise AssertionError(f"freon {gen} ({lane}): {rep}")
                        fr[f"{gen}_{lane}"] = rep
                print(f"chaos (f) freon on the {lane} lane: " + ", ".join(
                    f"{g} {fr[f'{g}_{lane}']['throughput_mib_s'] / 1024:.3f} GiB/s"
                    for g in ("dcg", "dcv", "dcb"))
                    + f", dnbp {fr[f'dnbp_{lane}']['ops_per_s']} blocks/s")
            rep = cli_json("freon", "ralg", "-n", str(8 * n_freon), "--root",
                           str(tmp / "ralg"))
            fr["ralg"] = rep["ops_per_s"]
            hsg = cli_json("freon", "hsg", "-n", "8", "-s", str(64 * 1024), "--om", addr,
                           "--device", dev)
            mark = begin()
            sdg = cli_json("freon", "sdg", "-n", "4", "-s", str(small), "--om", addr,
                           "--device", dev, "--replication", rs)
            end("chaos (f) freon sdg", "chaos_freon_sdg", mark)
            scmtb = cli_json("freon", "scmtb", "-n", str(8 * n_freon), "--om", addr,
                             "--replication", rs, "--device", dev)
            cmdw = cli_json("freon", "cmdw", "-n", str(n_freon), "-s", size, "--root",
                            str(tmp / "cmdw"))
            dbgen = cli_json("freon", "dbgen", "-n", str(32 * n_freon), "--root",
                             str(tmp / "dbgen.db"))
            for name, rep in (("hsg", hsg), ("sdg", sdg), ("scmtb", scmtb),
                              ("cmdw", cmdw), ("dbgen", dbgen)):
                if rep["failures"]:
                    raise AssertionError(f"freon {name}: {rep}")
            print(f"chaos (f) freon: ralg {fr['ralg']} raft appends/s; hsg "
                  f"{hsg['mean_ms']} ms per key of 4 hsyncs (p99 {hsg['p99_ms']} ms); sdg "
                  f"{sdg['mean_ms'] / 1e3:.3f} s per write+snapshot+snapdiff round; scmtb "
                  f"{scmtb['ops_per_s']} allocations/s; cmdw "
                  f"{cmdw['throughput_mib_s'] / 1024:.3f} GiB/s; dbgen "
                  f"{dbgen['ops_per_s']} keys/s")
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                if om_scale.main(["--keys", str(om_scale_keys), "--db",
                                  str(tmp / "omscale.db")]) != 0:
                    raise AssertionError("om_scale failed")
            fr["om_scale"] = json.loads(buf.getvalue().strip().splitlines()[-1])
            print(f"chaos (f) om_scale ({time.perf_counter() - t0:.1f} s): "
                  f"{json.dumps(fr['om_scale'])}")
            out["f"] = fr

            # ---- (d) a datanode process under the filesystem injector
            so = build_injector()
            if so is None:
                raise AssertionError("the failure injector did not build")
            fi = FaultInjector(tmp)
            xroot = tmp / "dnx"
            log_f = open(tmp / "dnx.log", "w")
            env = {**os.environ, **fi.env(), "PYTHONPATH": str(repo)}
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "ozone_tpu_torch.tools", "datanode", "--root",
                 str(xroot), "--scm", addr, "--id", "dnx", "--device", dev,
                 "--scan-interval", "1"], env=env, stdout=log_f,
                stderr=subprocess.STDOUT, cwd=str(repo))
            wait_for("dnx registered", lambda: "dnx" in {
                n["dn_id"] for n in scm.status()["nodes"]}, 180, poll_s=0.2)
            up_s = time.perf_counter() - t0
            print(f"chaos (d): a datanode process under LD_PRELOAD={so.name} registered "
                  f"{up_s:.2f} s after its start (its torch and CUDA start passed "
                  "through the shim)")
            dnx_addr = scm.node_addresses()["dnx"]
            for f_ in (oz.clients, rpc_f):
                f_.register_remote("dnx", dnx_addr)
            # EC writes whose first group starts on dnx, into a container it
            # already holds, so the EIO meets the chunk pwrites (the sidecar's
            # on the native lane, the chunk store's on the RPC lane); the
            # writer's retry group is placed around it
            opts = CoderOptions.parse(rs)
            ec_cfg = ReplicationConfig.from_ec(opts)
            members = ["dnx"] + [d.dn.id for d in dns[1:9]]
            others = [d.dn.id for d in dns[1:10]]
            cid0 = 90_000_000
            lanes = (("native", oz.clients), ("RPC", rpc_f))
            for li, (_, f_) in enumerate(lanes):
                for u, dn_id in enumerate(members):
                    f_.get(dn_id).create_container(cid0 + li, replica_index=u + 1)
            cont = xroot / "vol0" / "containers"
            fi.fail("write", cont, "EIO")
            time.sleep(1.3)  # the shim reads its rules at most once a second
            lids = itertools.count(1)
            mark = begin()
            for li, (lane, f_) in enumerate(lanes):
                def allocate(excluded, ec=(), _c=cid0 + li):
                    if "dnx" not in excluded:
                        return BlockGroup(container_id=_c, local_id=next(lids),
                                          pipeline=Pipeline(ec_cfg, members))
                    return BlockGroup(container_id=_c + 10, local_id=next(lids),
                                      pipeline=Pipeline(ec_cfg, others))

                data = rng.integers(0, 256, 2 * 6 * cell + 4096, dtype=np.uint8)
                w = ECKeyWriter(opts, allocate, f_, block_size=16 * cell,
                                bytes_per_checksum=bpc, device=device)
                w.write(data)
                groups = [g for g in w.close() if g.length]
                if "dnx" not in w._excluded or any("dnx" in g.pipeline.nodes
                                                   for g in groups):
                    raise AssertionError(f"chaos (d) {lane}: the writer did not "
                                         f"exclude dnx ({w._excluded})")
                got = np.concatenate([ECBlockGroupReader(
                    g, opts, f_, bytes_per_checksum=bpc, device=device).read_all()
                    for g in groups])
                if not np.array_equal(got, data):
                    raise AssertionError(f"chaos (d) {lane}: bytes differ")
            end("chaos (d) EC writes past EIO", "chaos_eio_put", mark)
            fi.clear()
            time.sleep(1.3)
            # the hand-made groups' containers leave: the SCM never knew them
            for li, (_, f_) in enumerate(lanes):
                for cid_, nodes_ in ((cid0 + li, members), (cid0 + 10 + li, others)):
                    for dn_id in nodes_:
                        try:
                            f_.get(dn_id).delete_container(cid_, force=True)
                        except StorageError as e:
                            if e.code != "CONTAINER_NOT_FOUND":
                                raise
            print(f"chaos (d): writes under {cont} fail with EIO: on the native "
                  "lane (the sidecar's pwrite) and the RPC lane (the chunk "
                  "store's), each writer excluded dnx after its first stripe run "
                  "and committed around it; reads byte-exact")
            # corrupted writes: with two datanodes partitioned, every group the
            # SCM allocates holds a unit on dnx
            blocked = dns[:2]
            for d in blocked:
                partition.block(d.address)
            try:
                fi.clear()
                fi.corrupt_writes(cont)
                time.sleep(1.3)
                mark = begin()
                bad = []
                for i in range(2):
                    name = f"bad-{i}"
                    put(b, name, rng.integers(0, 256, small, dtype=np.uint8))
                    bad.append(name)
                end("chaos (d) PUTs with dnx's writes corrupted", "chaos_corrupt_put",
                    mark)
            finally:
                for d in blocked:
                    partition.heal(d.address)
            fi.clear()
            time.sleep(1.3)
            hit = [n for n in bad if "dnx" in key_nodes(oz.om, "chaos", "ec", n)]
            if not hit:
                raise AssertionError("chaos (d): no corrupted key holds a unit on dnx")
            dnx_units = {}  # container -> replica index on dnx
            for n in hit:
                for g in oz.om.lookup_key("chaos", "ec", n)["block_groups"]:
                    if "dnx" in g["nodes"]:
                        dnx_units[int(g["container_id"])] = g["nodes"].index("dnx") + 1
            for c in scm.list_containers():
                if c["state"] == "OPEN" and c["id"] < 10 ** 7:
                    scm.admin("close-container", str(c["id"]))
            mark = begin()
            t0 = time.perf_counter()

            def replica(cid, dn_id):
                with meta.scm_service.lock:
                    r = meta.scm.containers.get(cid).replicas.get(dn_id)
                    return r.state if r is not None else None

            scan_s = wait_for("dnx's scanner marks its replicas UNHEALTHY", lambda: all(
                replica(cid, "dnx") == "UNHEALTHY" for cid in dnx_units), 120, poll_s=0.1)
            # dnx stops and the SCM sees it dead at once: the placement of the
            # rebuild could otherwise pick the node that holds the UNHEALTHY
            # replica (ROADMAP Queue 3, a shared fault)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
            log_f.close()
            meta.scm.nodes.get("dnx").last_heartbeat = -1e9
            meta.scm.nodes.check_liveness()

            def holder(cid, idx):
                with meta.scm_service.lock:
                    c0 = meta.scm.containers.get(cid)
                    held = [dn for dn, r in c0.replicas.items() if dn != "dnx"
                            and r.replica_index == idx and r.state == "CLOSED"]
                return held[0] if held else None

            try:
                wait_for("the SCM's rebuild of dnx's units", lambda: all(
                    holder(cid, idx) for cid, idx in dnx_units.items()), 120,
                    poll_s=0.1)
            except AssertionError:
                print("chaos (d): " + repr([c for c in scm.list_containers()
                                            if c["id"] in dnx_units])
                      + f"; failed commands { {d.dn.id: d.failed_commands for d in dns} }",
                      file=sys.stderr)
                raise
            # dnx's other replicas (groups of earlier attempts) are rebuilt too:
            # wait until every closed EC container holds every index, or a
            # plan made before a target's report lands would count that unit
            # lost again (the shared fault of ROADMAP Queue 3)
            def whole() -> bool:
                with meta.scm_service.lock:
                    return not ec_missing(meta)

            wait_for("every EC container whole again", whole, 120, poll_s=0.1)
            rebuild_s = time.perf_counter() - t0
            dec = end("chaos (d) the SCM's rebuild of the corrupted units",
                      "chaos_corrupt_rebuild", mark)
            chunks = 0
            for n in hit:
                groups = oz.om.key_block_groups(oz.om.lookup_key("chaos", "ec", n))
                if any("dnx" in g.pipeline.nodes for g in groups):
                    raise AssertionError(f"chaos (d): {n} still reads from dnx")
                chunks += check_ec_units(lambda d: by_id[d].dn, groups, written[n], bpc,
                                         f"chaos (d) {n}", crc_route="native")
            mark = begin()
            for n in bad:
                if not np.array_equal(b.read_key(n), written[n]):
                    raise AssertionError(f"chaos (d): {n} differs after the rebuild")
            end("chaos (d) GETs after the rebuild", "chaos_corrupt_get", mark, need=False)
            print(f"chaos (d): corrupted writes on dnx: containers {sorted(dnx_units)} "
                  f"marked UNHEALTHY by its scanner {scan_s:.2f} s after the close; dnx "
                  f"stopped (rc {proc.returncode}) and declared dead; rebuilt by the SCM "
                  f"{rebuild_s:.2f} s after the close with {dec} decode launches; "
                  f"{chunks} chunks of the rebuilt groups equal the numpy coder's units "
                  f"and the host CRC32C; GETs byte-exact")
            proc = None
            db_file = xroot / "vol0" / "metadata.db"
            stat0 = db_file.stat().st_mtime_ns, db_file.stat().st_size
            cid = min(dnx_units)
            ins = cli_json("debug", "container-inspect", str(cid), "--root", str(xroot))
            if not ins["scan_errors"] or ins["state"] != "UNHEALTHY" or \
                    (db_file.stat().st_mtime_ns, db_file.stat().st_size) != stat0:
                raise AssertionError(f"chaos (d): container-inspect: {ins}")
            print(f"chaos (d): debug container-inspect {cid} --root (offline): state "
                  f"{ins['state']}, {len(ins['scan_errors'])} scan errors (first: "
                  f"{ins['scan_errors'][0]}), the volume db untouched")
            out["d"] = {"start_s": up_s, "scan_s": scan_s, "rebuild_s": rebuild_s}

            # ---- (e) the operator's tools
            # a replica's backup and restore: a datanode outside the group
            # takes it while every node still lives
            g0 = oz.om.lookup_key("chaos", "ec", "k0")["block_groups"][0]
            cid, src = int(g0["container_id"]), g0["nodes"][2]
            dst = next(d.dn.id for d in dns if d.dn.id not in g0["nodes"])
            tar = tmp / f"c{cid}.tar"
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                if cli.main(["debug", "export-container", str(cid), "--dn", src,
                             "--file", str(tar), "--om", addr]) != 0 or \
                        cli.main(["debug", "import-container", str(cid), "--dn", dst,
                                  "--file", str(tar), "--om", addr]) != 0:
                    raise AssertionError("chaos (e): export/import-container failed")
            xfer_s = time.perf_counter() - t0
            blob = tar.read_bytes()[:4]
            codec = ("zstd" if blob == cp._ZSTD_MAGIC else "lz4"
                     if blob == cp._LZ4_MAGIC else "gzip" if blob[:2] == b"\x1f\x8b"
                     else "none")
            a_cl = RpcDatanodeClient(src, by_id[src].address)
            b_cl = RpcDatanodeClient(dst, by_id[dst].address)
            try:
                bid = BlockID(cid, int(g0["local_id"]))
                blk = b_cl.get_block(bid)
                same = all(np.array_equal(b_cl.read_chunk(bid, ch, verify=True),
                                          a_cl.read_chunk(bid, ch)) for ch in blk.chunks)
            finally:
                a_cl.close()
                b_cl.close()
            print(f"chaos (e): debug export-container {cid} from {src} and "
                  f"import-container to {dst} in {xfer_s:.3f} s, {tar.stat().st_size} B, "
                  f"codec negotiated {codec} (offered here: {cp.available_codecs()}); "
                  f"{len(blk.chunks)} chunks read back from {dst} verified and equal: "
                  f"{same}")
            if not same:
                raise AssertionError("chaos (e): the imported replica differs")
            # the SCM sees the index twice and deletes one copy; its delete is
            # queued again until a report drops the replica (ROADMAP Queue 3
            # item 7, a shared fault), so the repeat fails: let it settle and
            # count it apart from the repair's window below
            u_idx = g0["nodes"].index(src) + 1

            def copies() -> list:
                with meta.scm_service.lock:
                    return sorted(dn for dn, r in meta.scm.containers.get(
                        cid).replicas.items() if r.replica_index == u_idx)

            wait_for("one copy of the imported index", lambda: len(copies()) == 1, 30)
            time.sleep(2.0)
            excess = {d.dn.id: dict(d.failed_commands) for d in dns if d.failed_commands}
            for d in dns:
                d.failed_commands.clear()
            print(f"chaos (e): the SCM kept index {u_idx} of container {cid} on "
                  f"{copies()} and deleted the other copy; failed repeat deletes "
                  f"(the shared excess-delete fault): {excess}")
            stop_at = dns[2]
            victim = stop_at.dn.id
            every = [(v["name"], bk["name"], k["name"])
                     for v in oz.om.list_volumes()
                     for bk in oz.om.list_buckets(v["name"])
                     for k in oz.om.list_keys(v["name"], bk["name"])]

            def expected_on(vol_, bkt_, name, dn_id) -> bool:
                """A unit the key's fsck expects lives on dn_id: a data unit
                holding bytes, a parity unit, or any replica."""
                for g in oz.om.key_block_groups(oz.om.lookup_key(vol_, bkt_, name)):
                    ec = g.pipeline.replication.ec
                    want = range(len(g.pipeline.nodes)) if ec is None else [
                        i for i, ln in enumerate(block_lengths(
                            g.length, ec.data_units, ec.cell_size)) if ln > 0] + list(
                        range(ec.data_units, len(g.pipeline.nodes)))
                    if g.length and any(g.pipeline.nodes[i] == dn_id for i in want):
                        return True
                return False

            degraded = {f"/{v}/{bk}/{n}" for v, bk, n in every
                        if expected_on(v, bk, n, victim)}
            stop_server(stop_at)
            t0 = time.perf_counter()
            fsck = cli_json("fsck", "--om", addr)
            fsck_s = time.perf_counter() - t0
            flagged = {x["key"] for x in fsck["issues"] if x.get("state") == "DEGRADED"}
            print(f"chaos (e): {victim} stopped: fsck {fsck['keys']} in {fsck_s:.3f} s; "
                  f"DEGRADED exactly the {len(degraded)} keys with a unit there: "
                  f"{flagged == degraded}")
            if flagged != degraded or fsck["keys"]["UNRECOVERABLE"]:
                raise AssertionError(f"chaos (e): fsck {fsck} against {sorted(degraded)}")
            t_dead = [0.0]
            rep = repair_onto_spare(meta, dns, by_id, victim, device, bpc,
                                    "chaos (e) repair", "by the SCM's commands",
                                    on_dead=lambda: t_dead.__setitem__(
                                        0, time.perf_counter()))
            out["launches"]["chaos_repair"] = rep["launches"]
            healthy_s = wait_for("fsck all HEALTHY", lambda: cli_json(
                "fsck", "--om", addr)["keys"]["HEALTHY"] == len(every), 60, poll_s=0.2)
            healthy_s = time.perf_counter() - t_dead[0]
            print(f"chaos (e): every key HEALTHY in fsck {healthy_s:.3f} s after "
                  f"{victim}'s death")
            vr = cli_json("debug", "verify-replicas", "/chaos/ec/k0", "--om", addr)
            ci = cli_json("debug", "chunk-info", "/chaos/ec/k0", "--om", addr)
            n_chunks = sum(len(r["chunks"]) for g in ci for r in g["replicas"].values()
                           if isinstance(r, dict))
            print(f"chaos (e): debug verify-replicas k0: {len(vr)} units, "
                  f"{sorted({r['status'] for r in vr})}; "
                  f"chunk-info: {len(ci)} groups, {n_chunks} chunks")
            fsck0 = cli_json("fsck", "--om", addr)
            orph = cli_json("repair", "orphans", "--om", addr)
            deleted = cli_json("repair", "orphans", "--delete", "--om", addr)
            actions = collections.Counter(e["action"] for e in deleted["orphans"])
            again = cli_json("repair", "orphans", "--om", addr)
            fsck1 = cli_json("fsck", "--om", addr)
            print(f"chaos (e): repair orphans found {orph['count']} blocks of failed "
                  f"attempts; --delete: {dict(actions)}; then {again['count']} left "
                  f"(all in OPEN containers: "
                  f"{all(e['container_state'] == 'OPEN' for e in again['orphans'])}); "
                  f"fsck unchanged: {fsck1 == fsck0}")
            if orph["count"] < 1 or set(actions) - {"deleted", "skipped-open-container"} \
                    or fsck1 != fsck0 or any(e["container_state"] != "OPEN"
                                             for e in again["orphans"]):
                raise AssertionError(f"chaos (e): repair orphans {orph} / {deleted}")
            quota = cli_json("repair", "quota", "--volume", "chaos", "--om", addr)
            if quota["volume_key_count"] != len(oz.om.list_keys("chaos", "ec")):
                raise AssertionError(f"chaos (e): repair quota {quota}")
            copy = tmp / "om-copy.db"
            src_db = sqlite3.connect(str(meta.om.store._path))
            dst_db = sqlite3.connect(str(copy))
            src_db.backup(dst_db)
            src_db.close()
            dst_db.close()
            txn = cli_json("repair", "transaction", "--db", str(copy))
            print(f"chaos (e): repair quota {quota['volume_key_count']} keys, "
                  f"{quota['volume_used_bytes']} B; repair transaction (dry run on a "
                  f"copy of the OM db): {txn}")
            if txn["applied"]:
                raise AssertionError("chaos (e): the dry run applied")
            # the metadata daemon restarted: the pipeline rules gate allocation
            # (a PUT first, so an OPEN pipeline is there to recover)
            mark = begin()
            put(b, "before-restart", rng.integers(0, 256, small, dtype=np.uint8))
            end("chaos (e) PUT before the restart", "chaos_restart_put", mark)
            port = int(addr.rsplit(":", 1)[1])
            meta.stop()
            t0 = time.perf_counter()
            meta2 = ScmOmDaemon(meta.om.store._path, port=port, block_size=16 * cell,
                                container_size=4096 * cell, stale_after_s=30.0,
                                dead_after_s=60.0, background_interval_s=0.5,
                                placement_seed=seed, device=device)
            meta2.start()
            meta.stop = meta2.stop  # the cluster's exit stops the new daemon
            first = cli_json("admin", "safemode", "status", "--om", addr)
            wait_for("safemode exit", lambda: not cli_json(
                "admin", "safemode", "status", "--om", addr)["safemode"], 60, poll_s=0.1)
            sm_s = time.perf_counter() - t0
            st = cli_json("admin", "safemode", "status", "--om", addr)
            mark = begin()
            put(b, "after-restart", rng.integers(0, 256, small, dtype=np.uint8))
            end("chaos (e) PUT after the restart", "chaos_restart_put", mark)
            print(f"chaos (e): metadata daemon restarted; admin safemode at its start "
                  f"{first}; out of safemode {sm_s:.2f} s after the restart with "
                  f"pipelines {st['pipelines_healthy']}/{st['pipelines_total']} healthy, "
                  f"{st['pipelines_with_member']} with a member; a PUT allocated after")
            if st["pipelines_total"] < 1 or first["pipelines_total"] < 1 or \
                    not first["safemode"] or \
                    st["pipelines_healthy"] < st["pipelines_total"]:
                raise AssertionError(f"chaos (e): safemode {first} -> {st}")
            out["e"] = {"fsck_s": fsck_s, "healthy_s": healthy_s, "codec": codec,
                        "safemode_exit_s": sm_s}

            # freon dnsim last: its virtual nodes stay in the node table
            sim = cli_json("freon", "dnsim", "-n", str(dnsim_nodes), "--duration", "5",
                           "--om", addr)
            print(f"chaos (f) freon dnsim: {dnsim_nodes} simulated datanodes for 5 s: "
                  f"{sim['ops_per_s']} heartbeats/s, p99 {sim['p99_ms']} ms, "
                  f"{sim['fcrs']} full container reports, {sim['failures']} failures")
            if sim["failures"] or sim["ops"] <= 0:
                raise AssertionError(f"freon dnsim: {sim}")
            out["f"]["dnsim_hb_s"] = sim["ops_per_s"]
        finally:
            partition.clear()
            if fi is not None:
                fi.clear()
            if proc is not None:
                proc.kill()
                proc.wait(timeout=30)
            scm.close()
            rpc_oz.om.close()
            rpc_f.close()
    return out


# -------------------------------------------------------------- mesh path
#: the reference program each mesh form of the kernel replaces
MESH_FORMS = {"dp_encode": "ozone_tpu/parallel/sharded.py:115",
              "dp_decode": "ozone_tpu/parallel/sharded.py:168",
              "tp_encode": "ozone_tpu/parallel/sharded.py:232",
              "ring_decode": "ozone_tpu/parallel/sharded.py:291"}


def tp_slots(k: int, n: int, logical: dict) -> int:
    """Slots of a TP case: the logical mesh's stated count, else the most
    devices (at least 2) that divide k."""
    if logical:
        return logical[k]
    return max((m for m in range(2, n + 1) if k % m == 0), default=0)


def mesh_cases(devices: list, cell: int, bpc: int, seed: int, logical: bool) -> list[dict]:
    """The four mesh forms at the main path's width, each with its
    single-device kernel call, its plain version, its launches a call and
    its bound: DP encode RS(6,3) [32, 6, cell]; DP decode RS(10,4) [2, 10]
    (units 0 and 1 from 2..11, B = 8); TP encode RS(6,3) and RS(10,4) (on
    3 and 2 slots of a logical mesh); the ring decode of the same RS(10,4)
    pattern over every slot (10 survivors padded to a multiple of the
    slot count)."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import FusedSpec, _decode_matrix, _parity_matrix
    from ozone_tpu_torch.codec.torch_coder import apply_slice
    from ozone_tpu_torch.parallel import sharded
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY, ChecksumType

    n, dev0 = len(devices), torch.device(devices[0])
    mesh = sharded.make_mesh(devices=devices)
    rng = np.random.default_rng(seed + 23)
    rs63, rs104 = CoderOptions(6, 3, "rs", cell_size=cell), CoderOptions(10, 4, "rs", cell_size=cell)
    spec63 = FusedSpec(rs63, ChecksumType.CRC32C, bpc)
    spec104 = FusedSpec(rs104, ChecksumType.CRC32C, bpc)
    kernel, plain = fused_kernel.fused_encode_crc, fused_kernel.fused_encode_crc_plain

    def units(shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev0)

    def matrix(m):
        return torch.from_numpy(m).to(dev0)

    cases = []
    data, pm = units((32, 6, cell)), matrix(_parity_matrix(rs63))
    enc = sharded.make_sharded_fused_encoder(spec63, mesh)
    cases.append(dict(
        form="dp_encode", what=f"DP encode rs-6-3 [32, 6, {cell}]", slots=n,
        run=lambda: enc(data), single=lambda: kernel(data, pm, CRC32C_POLY, bpc),
        plain=lambda: plain(data, pm, CRC32C_POLY, bpc), launches=n,
        bound=fused_bound(32, 6, 3, cell, bpc), in_bytes=32 * 6 * cell))
    valid, erased = list(range(2, 12)), [0, 1]
    surv, dm = units((8, 10, cell)), matrix(_decode_matrix(rs104, valid, erased))
    dec = sharded.make_sharded_decoder(spec104, valid, erased, mesh)
    cases.append(dict(
        form="dp_decode", what=f"DP decode rs-10-4 [2, 10] B=8 cell={cell}", slots=n,
        run=lambda: dec(surv),
        single=lambda: kernel(surv, dm, CRC32C_POLY, bpc, crc_in=False),
        plain=lambda: plain(surv, dm, CRC32C_POLY, bpc, crc_in=False), launches=n,
        bound=fused_bound(8, 10, 2, cell, bpc, rows=2), in_bytes=8 * 10 * cell))
    for opts, tp_data in ((rs63, units((8, 6, cell))), (rs104, units((8, 10, cell)))):
        k, p = opts.data_units, opts.parity_units
        m = tp_slots(k, n, {6: 3, 10: 2} if logical else {})
        if not m:
            print(f"mesh: TP rs-{k}-{p} skipped: no slot count from 2 to {n} divides {k}")
            continue
        tp = sharded.make_tp_encoder(opts, sharded.make_mesh(devices=devices[:m]))
        tpm, sb = matrix(_parity_matrix(opts)), apply_slice(cell)
        cases.append(dict(
            form="tp_encode", what=f"TP encode rs-{k}-{p} [8, {k}, {cell}]", slots=m,
            run=lambda tp=tp, d=tp_data: (tp(d),),
            single=lambda d=tp_data, a=tpm: kernel(d, a, None, sb)[:1],
            plain=lambda d=tp_data, a=tpm: (fused_kernel.gf_apply_plain(d, a),),
            launches=m + 1, bound=fused_bound(8, k, p, cell, bpc, rows=0),
            in_bytes=8 * k * cell))
    ring = sharded.make_ring_decoder(spec104, valid, erased, mesh)
    cases.append(dict(
        form="ring_decode",
        what=f"ring decode rs-10-4 [2, 10] B=8 cell={cell}, 10 survivors padded to "
             f"{-(-10 // n) * n}", slots=n,
        run=lambda: ring(surv),
        single=lambda: kernel(surv, dm, CRC32C_POLY, bpc, crc_in=False),
        plain=lambda: plain(surv, dm, CRC32C_POLY, bpc, crc_in=False),
        launches=n + n * (n - 1) + min(n, 8),
        bound=fused_bound(8, 10, 2, cell, bpc, rows=2), in_bytes=8 * 10 * cell))
    return cases


def check_mesh_cases(cases: list, device, where: str) -> None:
    """Run each case once: its outputs equal the single-device kernel's and
    the plain version's bit for bit, and on the card its launches a call
    are the form's count (every one of them a kernel launch). Records each
    case's largest difference in `err`."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.parallel import sharded

    for case in cases:
        form, counter = case["form"], sharded.launches[case["form"]]
        before, total = counter.count, fused_kernel.launches.count
        got = case["run"]()
        got = got if isinstance(got, tuple) else (got,)
        if device.type == "cuda":
            torch.cuda.synchronize()
        launched, all_launched = counter.count - before, fused_kernel.launches.count - total
        err = 0
        for name, want in (("single-device kernel", case["single"]()),
                           ("plain version", case["plain"]())):
            for g, w in zip(got, want):
                w = w.to(g.device)
                if g.shape != w.shape:
                    raise AssertionError(f"mesh {case['what']} on {where}: shape "
                                         f"{tuple(g.shape)} != {name}'s {tuple(w.shape)}")
                if g.numel():
                    err = max(err, (g.long() - w.long()).abs().max().item())
            if err:
                raise AssertionError(f"mesh {case['what']} on {where} differs from the "
                                     f"{name} (max_abs_err {err})")
        case["err"], case["launched"] = err, launched
        print(f"mesh {case['what']} on {case['slots']} slots of {where}: equal to the "
              f"single-device kernel and the plain version bit for bit; launches "
              f"{launched} a call (of the kernel {all_launched}), expected {case['launches']}")
        if device.type == "cuda" and not launched == all_launched == case["launches"]:
            raise AssertionError(f"mesh {case['what']}: {launched} form launches, "
                                 f"{all_launched} kernel launches, not {case['launches']}")


def time_mesh_cases(cases: list, where: str) -> None:
    """CUDA-event times of each case: a single call and a call in a run of
    10, beside the single-device kernel's single call, the plain version
    and the bound."""
    for case in cases:
        case["ms"] = cuda_ms(case["run"], rounds=10)
        case["ms_in_run"] = cuda_ms(case["run"], calls=10, rounds=5)
        case["single_ms"] = cuda_ms(case["single"], rounds=10)
        case["plain_ms"] = cuda_ms(case["plain"], rounds=3)
        bound_ms, bound_by = case["bound"]
        print(f"mesh {case['what']} on {case['slots']} slots of {where}: {case['ms']:.4f} ms "
              f"a single call ({case['ms_in_run']:.4f} ms in a run of 10), single-device "
              f"kernel {case['single_ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), "
              f"{case['in_bytes'] / case['ms'] * 1e3 / 2**30:.2f} GiB/s in")


def mesh_executor_step(ex, device, cell: int, bpc: int, seed: int) -> dict:
    """(b): four encode operations (RS(6,3), [4, 6, cell] each) and four
    decode operations (RS(10,4), [2, 10, cell] each) submitted at once
    from eight threads to the executor, per-slot width 2; each result
    equals the plain version's, and every dispatch is one launch a slot."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec import service as codec_service
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import FusedSpec, _decode_matrix, _parity_matrix
    from ozone_tpu_torch.parallel import mesh_executor, sharded
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY, ChecksumType

    rng = np.random.default_rng(seed + 29)
    rs63, rs104 = CoderOptions(6, 3, "rs", cell_size=cell), CoderOptions(10, 4, "rs", cell_size=cell)
    valid, erased = list(range(2, 12)), [0, 1]
    ops = ([("encode", rng.integers(0, 256, (4, 6, cell), dtype=np.uint8)) for _ in range(4)]
           + [("decode", rng.integers(0, 256, (2, 10, cell), dtype=np.uint8)) for _ in range(4)])
    keys = {"encode": codec_service.encode_key(FusedSpec(rs63, ChecksumType.CRC32C, bpc)),
            "decode": codec_service.decode_key(FusedSpec(rs104, ChecksumType.CRC32C, bpc),
                                               valid, erased)}
    snap0 = mesh_executor.METRICS.snapshot()
    form0 = {f: sharded.launches[f].count for f in ("dp_encode", "dp_decode")}
    barrier = threading.Barrier(len(ops))

    def op(i):
        kind, stripes = ops[i]
        barrier.wait(timeout=60)
        return ex.submit(keys[kind], stripes, width=2).result(timeout=120)

    results = concurrent(op, list(range(len(ops))))
    ex.quiesce()
    for (kind, stripes), got in zip(ops, results):
        t = torch.from_numpy(stripes).to(device)
        if kind == "encode":
            m, crc_in = _parity_matrix(rs63), True
        else:
            m, crc_in = _decode_matrix(rs104, valid, erased), False
        want = fused_kernel.fused_encode_crc_plain(
            t, torch.from_numpy(m).to(device), CRC32C_POLY, bpc, crc_in)
        if not (np.array_equal(got[0], want[0].cpu().numpy())
                and np.array_equal(got[1], want[1].cpu().numpy().view(np.uint32))):
            raise AssertionError(f"mesh executor {kind} differs from the plain version")
    snap1 = mesh_executor.METRICS.snapshot()
    delta = {k: snap1.get(k, 0) - snap0.get(k, 0) for k in
             ("submissions", "dispatches", "coalesced_operations", "multi_op_dispatches",
              "stripes_dispatched", "slots_dispatched")}
    launched = sum(sharded.launches[f].count - form0[f] for f in form0)
    stats = ex.stats()
    print(f"mesh executor: 8 concurrent operations (4 encode, 4 decode) equal to the plain "
          f"version; {json.dumps(delta)}; launches {launched}; stats " + json.dumps(
              {k: stats[k] for k in ("fill_ratio", "ops_per_dispatch", "max_inflight",
                                     "devices", "mesh_depth", "programs",
                                     "programs_host_twin", "compile_counts", "queue_depth",
                                     "lanes", "inflight", "spill_enabled", "enabled")}))
    if delta["submissions"] != 8 or not delta["dispatches"]:
        raise AssertionError(f"mesh executor: {delta}")
    if device.type == "cuda" and launched != ex.n_devices * delta["dispatches"]:
        raise AssertionError(f"mesh executor: {launched} launches for "
                             f"{delta['dispatches']} dispatches of {ex.n_devices} slots")
    return {"launches": launched, **delta}


def mesh_spill_step(device, cell: int, bpc: int, seed: int) -> dict:
    """(c) the codec service's spill at watermark 4: its dispatcher held on
    a slow lane, twelve one-stripe RS(6,3) encodes queue past the
    watermark and their whole lane moves to the installed executor; every
    result equals the plain version's."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec import service as codec_service
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import FusedSpec, _parity_matrix, make_fused_encoder
    from ozone_tpu_torch.parallel import mesh_executor, sharded
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY, ChecksumType

    opts = CoderOptions(6, 3, "rs", cell_size=cell)
    spec = FusedSpec(opts, ChecksumType.CRC32C, bpc)
    enc0 = sharded.launches["dp_encode"].count
    rng = np.random.default_rng(seed + 31)
    datas = [rng.integers(0, 256, (1, 6, cell), dtype=np.uint8) for _ in range(12)]
    release = threading.Event()

    def slow(batch):
        release.wait(timeout=60)
        return (np.array(batch, copy=True),)

    with env_set(OZONE_TPU_MESH_SPILL=1, OZONE_TPU_MESH_SPILL_WATERMARK=4):
        svc = codec_service.CodecService()
        s0, m0 = codec_service.METRICS.snapshot(), mesh_executor.METRICS.snapshot()
        try:
            if not mesh_executor.maybe_executor().accepts(codec_service.encode_key(spec)):
                raise AssertionError("the mesh executor takes no RS(6,3) encode")
            plug = svc.submit(("encode", "slow-plug"), slow,
                              np.zeros((1, 4), dtype=np.uint8), width=1)
            time.sleep(0.05)
            fn = make_fused_encoder(spec, device=device)
            futs = [svc.submit(codec_service.encode_key(spec), fn, d, width=1)
                    for d in datas]
            release.set()
            plug.result(timeout=60)
            results = [f.result(timeout=120) for f in futs]
        finally:
            release.set()
            svc.close()
    pm = torch.from_numpy(_parity_matrix(opts)).to(device)
    for d, (parity, crcs) in zip(datas, results):
        want = fused_kernel.fused_encode_crc_plain(torch.from_numpy(d).to(device), pm,
                                                   CRC32C_POLY, bpc)
        if not (np.array_equal(parity, want[0].cpu().numpy())
                and np.array_equal(crcs, want[1].cpu().numpy().view(np.uint32))):
            raise AssertionError("a spilled encode differs from the plain version")
    s1, m1 = codec_service.METRICS.snapshot(), mesh_executor.METRICS.snapshot()
    out = {k: s1.get(k, 0) - s0.get(k, 0) for k in ("mesh_spill_lanes", "mesh_spill_stripes")}
    out.update({k: m1.get(k, 0) - m0.get(k, 0) for k in ("spilled_lanes", "dispatches")})
    out["launches"] = sharded.launches["dp_encode"].count - enc0
    ex = mesh_executor.maybe_executor()
    print(f"codec service spill at watermark 4: 12 encodes equal to the plain version; "
          f"{json.dumps(out)}")
    if out["mesh_spill_lanes"] < 1 or out["mesh_spill_stripes"] < 8:
        raise AssertionError(f"the service spilled nothing: {out}")
    if device.type == "cuda" and out["launches"] != ex.n_devices * out["dispatches"]:
        raise AssertionError("the spilled lane's DP launches differ from its dispatches")
    return out


def mesh_consumers_step(mesh, ex, device, cell: int, bpc: int, seed: int) -> dict:
    """(c) on 16 in-process datanodes, RS(10,4): a key of one full group
    and a short one; a degraded GET with units 0 and 1 down through
    `ECBlockGroupReader(mesh=, use_ring=True)`; their replicas rebuilt onto
    two spares by `ECReconstructionCoordinator(mesh=)` (DP decode), equal
    to the lost ones; each rebuilt container scrubbed with
    `DeviceScrubber(mesh=)`, agreeing with the host scan. Each step's
    launches are counted against its form."""
    from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.pipeline import batched, decode_batch_size
    from ozone_tpu_torch.parallel import sharded
    from ozone_tpu_torch.storage.reconstruction import (
        ECReconstructionCoordinator,
        ReconstructionCommand,
    )
    from ozone_tpu_torch.storage.scrubber import DeviceScrubber

    n = mesh.devices.size
    opts = CoderOptions(10, 4, "rs", cell_size=cell)
    row = 10 * cell
    data = np.random.default_rng(seed + 37).integers(0, 256, 16 * row + 12345, dtype=np.uint8)
    lost, spares = [0, 1], ["dn14", "dn15"]
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as tmp:
        cluster = Cluster(Path(tmp), opts, 16)
        try:
            (groups,), _ = put_keys(cluster, [data], device, bpc)
            cluster.dead = {groups[0].pipeline.nodes[u] for u in lost}
            ring0, total0 = sharded.launches["ring_decode"].count, fused_kernel.launches.count
            got, expect = [], 0
            t0 = time.perf_counter()
            for g in groups:
                r = ECBlockGroupReader(g, opts, cluster.clients, bytes_per_checksum=bpc,
                                       device=device, mesh=mesh, use_ring=True)
                got.append(r.read_all())
                stripes = [s for s in range(r.num_stripes)
                           if any(s * row + u * cell < g.length for u in lost)]
                expect += sum(n + n * (n - 1) + min(n, len(sb))
                              for sb in batched(stripes, decode_batch_size()))
            wall = time.perf_counter() - t0
            out["mesh_degraded_get_ring"] = sharded.launches["ring_decode"].count - ring0
            if not np.array_equal(np.concatenate(got), data):
                raise AssertionError("the degraded GET over the ring differs from the source")
            print(f"mesh degraded GET (units {lost} down, ring over {n} slots): {data.size} B "
                  f"byte-exact in {wall:.3f} s ({data.size / wall / 2**30:.3f} GiB/s wall); "
                  f"ring launches {out['mesh_degraded_get_ring']}, expected {expect} "
                  f"(of the kernel {fused_kernel.launches.count - total0})")
            if device.type == "cuda" and out["mesh_degraded_get_ring"] != expect:
                raise AssertionError("the degraded GET's ring launches differ")

            coord = ECReconstructionCoordinator(cluster.clients, bytes_per_checksum=bpc,
                                                device=device, mesh=mesh)
            dec0 = sharded.launches["dp_decode"].count
            t0 = time.perf_counter()
            for g in groups:
                coord.reconstruct_container_group(ReconstructionCommand(
                    g.container_id, opts,
                    {u + 1: nd for u, nd in enumerate(g.pipeline.nodes) if u not in lost},
                    {u + 1: spare for u, spare in zip(lost, spares)}))
            repair_s = time.perf_counter() - t0
            out["mesh_rebuild"] = sharded.launches["dp_decode"].count - dec0
            batches = coord.metrics.counter("decode_dispatches").value
            rebuilt = check_rebuilt(cluster, groups, lost, spares, bpc)
            print(f"mesh rebuild (ECReconstructionCoordinator(mesh=), DP over {n} slots): "
                  f"{len(groups)} containers onto {spares} in {repair_s:.3f} s, "
                  f"{rebuilt['chunks']} chunks equal the lost ones, CRCs equal host CRC32C; "
                  f"launches {out['mesh_rebuild']} for {batches} decode batches")
            if device.type == "cuda" and out["mesh_rebuild"] != n * batches:
                raise AssertionError("the rebuild's DP launches differ")

            scrubber = DeviceScrubber(device=device, mesh=mesh)
            total0 = fused_kernel.launches.count
            for spare in spares:
                dn = cluster.dns[spare]
                for g in groups:
                    errs = scrubber.scrub_container(dn, g.container_id, mark_unhealthy=False)
                    if errs or dn.scan_container(g.container_id):
                        raise AssertionError(f"scrub of rebuilt {g.container_id} on {spare}: "
                                             f"{errs}")
            out["mesh_scrub"] = fused_kernel.launches.count - total0
            print(f"mesh scrub (DeviceScrubber(mesh=), {n} slots): {2 * len(groups)} rebuilt "
                  f"containers clean, as the host scan says; launches {out['mesh_scrub']} for "
                  f"{scrubber.dispatches} slice batches")
            if device.type == "cuda" and out["mesh_scrub"] != n * scrubber.dispatches:
                raise AssertionError("the scrub's launches differ")
        finally:
            cluster.close()
    return out


def mesh_storm_step(ex, device, cell: int, bpc: int, seed: int) -> dict:
    """(c) `ReconstructionStorm(executor=)` on a MiniOzoneCluster of 12
    datanodes (rs-6-3, blocks of 2 cells, containers of 3 blocks): the
    datanode holding the most closed EC containers dies and the storm
    rebuilds them through the executor's lanes; every rebuilt chunk equals
    the lost one."""
    from ozone_tpu_torch.client.reconstruction import ReconstructionStorm
    from ozone_tpu_torch.parallel import sharded
    from ozone_tpu_torch.scm.pipeline import ReplicationType
    from ozone_tpu_torch.storage.ids import ContainerState
    from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

    block = 2 * cell
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-storm-") as tmp:
        cluster = MiniOzoneCluster(Path(tmp), num_datanodes=12, racks=3, block_size=block,
                                   container_size=3 * block, stale_after_s=1e6,
                                   dead_after_s=2e6, placement_seed=seed, device=device)
        try:
            bucket = cluster.client().create_volume("mesh").create_bucket(
                "b", replication=f"rs-6-3-{cell // 1024}k")
            rng = np.random.default_rng(seed + 41)
            for i in range(12):
                bucket.write_key(f"k{i}", rng.integers(0, 256, 6 * block, dtype=np.uint8))
            for dn in cluster.datanodes:
                for c in dn.list_containers():
                    if c.state is ContainerState.OPEN:
                        dn.close_container(c.id)
            cluster.tick()
            cluster.heartbeat_all()
            held: dict[str, list] = {}
            for c in cluster.scm.containers.containers():
                if c.replication.type is ReplicationType.EC \
                        and c.state is ContainerState.CLOSED:
                    for dn_id in c.replicas:
                        held.setdefault(dn_id, []).append(c)
            victim = max(sorted(held), key=lambda d: len(held[d]))
            vdn = cluster.datanode(victim)
            lost = {(c.id, bd.block_id.local_id): [vdn.read_chunk(bd.block_id, i)
                                                   for i in bd.chunks]
                    for c in held[victim] for bd in vdn.list_blocks(c.id)}
            kill_datanode(cluster, victim)
            dec0 = sharded.launches["dp_decode"].count
            report = ReconstructionStorm(cluster.scm, cluster.clients, executor=ex,
                                         device=device).repair_datanode(victim)
            launched = sharded.launches["dp_decode"].count - dec0
            if not report.ok or report.containers_repaired != len(held[victim]):
                raise AssertionError(f"mesh storm: {report}")
            for (cid, local_id), chunks in lost.items():
                for dn in cluster.datanodes:
                    if dn.id == victim or cid not in [c.id for c in dn.list_containers()]:
                        continue
                    blk = next((b for b in dn.list_blocks(cid)
                                if b.block_id.local_id == local_id), None)
                    if blk is None or len(blk.chunks) != len(chunks):
                        continue
                    if all(np.array_equal(dn.read_chunk(blk.block_id, i, verify=True), w)
                           for i, w in zip(blk.chunks, chunks)):
                        break
                else:
                    raise AssertionError(f"mesh storm: block {cid}/{local_id} not rebuilt")
            print(f"mesh storm (ReconstructionStorm(executor=)): {victim} dead, "
                  f"{report.containers_repaired} containers rebuilt byte-exact in "
                  f"{report.elapsed_s:.3f} s; mesh_dispatches {report.mesh_dispatches}, "
                  f"mesh_stripes {report.mesh_stripes}, mesh_coalesced_ops "
                  f"{report.mesh_coalesced_ops}, mesh_multi_op_dispatches "
                  f"{report.mesh_multi_op_dispatches}, mesh_max_inflight "
                  f"{report.mesh_max_inflight}; launches {launched}")
            if not report.mesh_dispatches:
                raise AssertionError("the storm never reached the mesh executor")
            if device.type == "cuda" and launched != ex.n_devices * report.mesh_dispatches:
                raise AssertionError("the storm's DP launches differ from its mesh dispatches")
        finally:
            cluster.close()
    return {"mesh_storm": launched}


def mesh_worker(rank: int, port: int, device: str) -> int:
    """One rank of the two-process run: a global mesh of one slot per
    process (NCCL on a GPU each, gloo on the CPU); DP encode on this rank's
    rows, then TP encode and the ring decode across the process boundary,
    each equal to the plain version on this rank's device."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import FusedSpec, _decode_matrix, _parity_matrix
    from ozone_tpu_torch.parallel import multihost, sharded
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY, ChecksumType

    cell, bpc = (MIB, 16 * 1024) if device == "cuda" else (64 * 1024, 16 * 1024)
    multihost.initialize(f"127.0.0.1:{port}", 2, rank, device=device)
    mesh = multihost.global_codec_mesh()
    dev = mesh.first_device
    rng = np.random.default_rng(43)
    rs63, rs104 = CoderOptions(6, 3, "rs", cell_size=cell), CoderOptions(10, 4, "rs", cell_size=cell)
    data = torch.from_numpy(rng.integers(0, 256, (8, 6, cell), dtype=np.uint8))
    surv = torch.from_numpy(rng.integers(0, 256, (8, 10, cell), dtype=np.uint8))
    pm63 = torch.from_numpy(_parity_matrix(rs63)).to(dev)
    valid, erased = list(range(2, 12)), [0, 1]
    dm = torch.from_numpy(_decode_matrix(rs104, valid, erased)).to(dev)
    plain = fused_kernel.fused_encode_crc_plain
    checks = {
        "DP encode": (sharded.make_sharded_fused_encoder(
            FusedSpec(rs63, ChecksumType.CRC32C, bpc), mesh)(data[rank * 4:rank * 4 + 4]),
            plain(data[rank * 4:rank * 4 + 4].to(dev), pm63, CRC32C_POLY, bpc)),
        "TP encode": ((sharded.make_tp_encoder(rs63, mesh)(data),),
                      (fused_kernel.gf_apply_plain(data.to(dev), pm63),)),
        "ring decode": (sharded.make_ring_decoder(
            FusedSpec(rs104, ChecksumType.CRC32C, bpc), valid, erased, mesh)(surv),
            plain(surv.to(dev), dm, CRC32C_POLY, bpc, crc_in=False)),
    }
    for name, (got, want) in checks.items():
        if not all(torch.equal(g.to(dev), w) for g, w in zip(got, want)):
            raise AssertionError(f"rank {rank}: {name} across processes differs")
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print(f"MESH_WORKER_OK {rank} on {dev}: " + ", ".join(checks), flush=True)
    return 0


def two_process_run(device_type: str) -> float:
    """Two `chip_smoke.py --mesh-worker` processes on one host (NCCL, a
    GPU each; or gloo on the CPU); both must finish OK within 300 s."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-worker", str(rank), str(port),
         device_type], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode or f"MESH_WORKER_OK {rank}" not in out:
            raise AssertionError(f"mesh worker {rank} failed:\n{out[-4000:]}")
        print(out.strip().splitlines()[-1])
    return time.perf_counter() - t0


def mesh_path(device, cell: int, bpc: int, seed: int, slots: int = 4) -> dict:
    """The multi-device codec (`parallel/`), every form through the fused
    kernel: (a) the forms on a logical mesh of `slots` slots on `device`
    (mesh_cases), each equal to the single-device kernel and the plain
    version with its launches a call; (b) the mesh executor over that mesh,
    installed as the process singleton, under concurrent encode and decode
    operations; (c) its consumers: a degraded GET over the ring, a rebuild
    and a scrub over the mesh, a storm through the executor and the codec
    service's spill at watermark 4; then the forms' times. (d) With two or
    more GPUs, the forms on a mesh of every GPU and a two-process NCCL run;
    with one, a line saying they were not run. Every form's launches are
    counted from 0 before (a) and read after (c)."""
    from ozone_tpu_torch.parallel import mesh_executor, sharded

    logical = [device] * slots
    where = f"{device} ({slots} logical slots)"
    if device.type == "cuda":
        from ozone_tpu_torch.codec import fused_kernel
        from ozone_tpu_torch.codec.torch_coder import apply_slice

        # the combines' inputs: n p units side by side (TP), 2 e (ring)
        for units, rows in ((9, 3), (8, 4), (4, 2), (40, 4)):
            smem, per_sm = fused_kernel.kernel_occupancy(units, rows, apply_slice(cell), 0)
            print(f"mesh combine [{rows}, {units}] at slice {apply_slice(cell)}: {smem} B "
                  f"shared memory per block (of {fused_kernel.MAX_SMEM_BYTES}), "
                  f"{per_sm} blocks per SM")
    cases = mesh_cases(logical, cell, bpc, seed, logical=True)
    for counter in sharded.launches.values():
        counter.reset()
    check_mesh_cases(cases, device, where)
    mesh = sharded.make_mesh(devices=logical)
    ex = mesh_executor.MeshExecutor(mesh=mesh, depth=2)
    installed, mesh_executor._executor = mesh_executor._executor, ex
    try:
        out = {"launches": {"mesh_executor": mesh_executor_step(ex, device, cell, bpc,
                                                                seed)["launches"]}}
        out["launches"].update(mesh_consumers_step(mesh, ex, device, cell, bpc, seed))
        out["launches"].update(mesh_storm_step(ex, device, cell, bpc, seed))
        out["launches"]["mesh_spill"] = mesh_spill_step(device, cell, bpc, seed)["launches"]
    finally:
        mesh_executor._executor = installed
        ex.close()
    out["form_launches"] = {f: c.count for f, c in sharded.launches.items()}
    out["launches"]["mesh_forms"] = sum(c["launched"] for c in cases)
    print(f"mesh path launches by form: {out['form_launches']}")
    for form, n in out["form_launches"].items():
        if device.type == "cuda" and n <= 0:
            raise AssertionError(f"mesh form {form} launched no kernel on the mesh path")
    out["cases"] = cases
    if device.type == "cuda":
        time_mesh_cases(cases, where)
    n_gpu = torch.cuda.device_count() if device.type == "cuda" else 0
    if n_gpu >= 2:
        real = [torch.device("cuda", i) for i in range(n_gpu)]
        out["real_cases"] = mesh_cases(real, cell, bpc, seed, logical=False)
        check_mesh_cases(out["real_cases"], device, f"{n_gpu} GPUs")
        time_mesh_cases(out["real_cases"], f"{n_gpu} GPUs")
        out["nccl_s"] = two_process_run("cuda")
        print(f"mesh two-process NCCL run: OK in {out['nccl_s']:.1f} s")
    else:
        print(f"mesh_path (d): {n_gpu} GPU on this host: the mesh over distinct GPUs and "
              "the two-process NCCL lane were not run; every mesh number above is of "
              "logical slots on one card")
    return out


def mesh_kernel_entries(mesh: dict) -> list[dict]:
    """The kernels JSON line's entries of the mesh forms: one per form, the
    first case of each, with TP's second case beside it."""
    entries = []
    for form, replaces in MESH_FORMS.items():
        cases = [c for c in mesh["cases"] if c["form"] == form]
        first = cases[0]
        entry = {
            "name": f"fused_encode_crc as mesh {first['what']} on {first['slots']} "
                    "logical slots of one card",
            "route": "cuda", "source": "ozone_tpu_torch/csrc/fused_encode_crc.cu",
            "replaces": replaces, "launches": mesh["form_launches"][form],
            "launches_a_call": first["launches"], "max_abs_err": first["err"],
            "ms": first["ms"], "ms_in_run": first["ms_in_run"],
            "single_device_ms": first["single_ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound"][0], "bound_by": first["bound"][1], "library_ms": None,
        }
        for other in cases[1:]:
            scheme = other["what"].split(" [")[0].split()[-1].replace("-", "")
            tag = f"{scheme}_{other['slots']}_slots"
            entry.update({f"{tag}_{k}": other[v] for k, v in (
                ("launches_a_call", "launches"), ("max_abs_err", "err"), ("ms", "ms"),
                ("ms_in_run", "ms_in_run"), ("single_device_ms", "single_ms"),
                ("plain_ms", "plain_ms"))})
            entry[f"{tag}_bound_ms"] = other["bound"][0]
        entries.append(entry)
    return entries


# -------------------------------------------------------------- host path
#: the shapes of the policy's verdicts in host_path (a): (what, scheme,
#: out_ratio), the encode's p/k and two decodes' e/v
HOST_VERDICTS = (("encode rs-6-3 (p/k)", "rs-6-3", 3 / 6),
                 ("decode rs-10-4 (2/10)", "rs-10-4", 2 / 10),
                 ("decode rs-6-3 (1/6)", "rs-6-3", 1 / 6))


def host_probe_step(cell: int) -> dict:
    """(a) The backend policy under OZONE_TPU_FUSED_BACKEND=auto on the
    card: its link probe (pageable h2d and d2h, with pinned beside it for
    information), the twin's rate for rs-6-3, rs-10-4 and lrc-12-2-2, and
    the verdict of each HOST_VERDICTS shape, each equal to the ceiling
    formula applied to the printed numbers."""
    from ozone_tpu_torch.codec import fused
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.utils.checksum import ChecksumType

    fused._PROBE_CACHE.clear()
    out = {"verdicts": {}}
    with env_set(OZONE_TPU_FUSED_BACKEND="auto", OZONE_TPU_LINK_PROBE="1"):
        for what, scheme, ratio in HOST_VERDICTS:
            opts = CoderOptions.parse(f"{scheme}-{cell}")
            host = fused._prefer_host_coder(opts, ratio, ChecksumType.CRC32C, "cuda")
            out["verdicts"][what] = "host twin" if host else "cuda"
    link = fused._PROBE_CACHE.get("link")
    if not isinstance(link, tuple):
        raise AssertionError(f"the link probe gave no sample on the card: {link!r}")
    h2d, d2h = link
    pinned = fused._measure_link(pinned=True)
    rates = {}
    for scheme in ("rs-6-3", "rs-10-4", "lrc-12-2-2"):
        opts = CoderOptions.parse(f"{scheme}-{cell}")
        rates[scheme] = fused._PROBE_CACHE.get(("native_rate", opts))
        if rates[scheme] is None:
            rates[scheme] = fused._native_rate_sample(opts)
    print(f"host path (a) link probe: h2d {h2d:.1f} MiB/s, d2h {d2h:.1f} MiB/s pageable "
          f"(the policy's sample); pinned h2d {pinned[0]:.1f}, d2h {pinned[1]:.1f} MiB/s "
          f"(information)")
    print("host path (a) host twin rate (_native_rate_sample, 4 stripes of 256 KiB "
          "cells): " + ", ".join(f"{k} {v:.1f} MiB/s" for k, v in rates.items()))
    for what, scheme, ratio in HOST_VERDICTS:
        ceiling = 1.0 / (1.0 / h2d + ratio / d2h)
        want = "cuda" if ceiling > rates[scheme] else "host twin"
        got = out["verdicts"][what]
        print(f"host path (a) verdict {what}: {got} (ceiling {ceiling:.1f} MiB/s against "
              f"the twin's {rates[scheme]:.1f})")
        if got != want:
            raise AssertionError(f"verdict for {what} is {got}; the numbers give {want}")
    counts = {k: fused.METRICS.counter(k).value for k in ("verdicts_host", "verdicts_device")}
    print(f"host path (a) verdict counters: {counts}")
    out.update(h2d=h2d, d2h=d2h, pinned=pinned, rates=rates)
    return out


def host_twin_cases(device, cases, decode_cases, seed: int) -> int:
    """(b) The twin (`_native_fused_encoder`, `_native_fused_decoder`, fed
    the CUDA tensor) against the kernel and its plain version on every
    CRC32C encode and decode case of the kernel phase, exact; then, under
    OZONE_TPU_FUSED_BACKEND=native, a CRC32 spec's encoder is the kernel
    and launches once. Returns the cases compared."""
    from ozone_tpu_torch.codec import fused, fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _POLY, FusedSpec, _decode_matrix, _parity_matrix
    from ozone_tpu_torch.utils.checksum import ChecksumType

    rng = np.random.default_rng(seed + 41)
    poly = _POLY[ChecksumType.CRC32C]
    n = 0
    for k, p, cell, bpc, b, checksum, *rest in cases:
        crc_in = rest[0] if rest else True
        scheme = rest[1] if len(rest) > 1 else f"rs-{k}-{p}"
        if checksum != "CRC32C" or not p or not crc_in:
            continue  # the twin serves the CRC32C encode and decode only
        opts = CoderOptions.parse(f"{scheme}-{cell}")
        data = torch.from_numpy(rng.integers(0, 256, (b, k, cell), dtype=np.uint8)).to(device)
        matrix = torch.from_numpy(_parity_matrix(opts)).to(device)
        outs = [fused_kernel.fused_encode_crc(data, matrix, poly, bpc),
                fused_kernel.fused_encode_crc_plain(data, matrix, poly, bpc)]
        twin = fused._native_fused_encoder(opts, ChecksumType.CRC32C, bpc).run(data)
        same = all(torch.equal(twin[i], o[i].cpu()) for o in outs for i in (0, 1))
        print(f"host twin vs kernel and plain: {scheme} encode cell={cell} bpc={bpc} B={b}: "
              f"{'exact' if same else 'DIFFERS'}")
        if not same:
            raise AssertionError(f"the host twin differs on {scheme} encode B={b}")
        n += 1
    for scheme, valid, erased, cell, bpc, b, checksum in decode_cases:
        if checksum != "CRC32C":
            continue
        opts = CoderOptions.parse(f"{scheme}-{cell}")
        data = torch.from_numpy(rng.integers(0, 256, (b, opts.data_units, cell),
                                             dtype=np.uint8)).to(device)
        parity, _ = fused_kernel.fused_encode_crc_plain(
            data, torch.from_numpy(_parity_matrix(opts)).to(device), None, bpc)
        units = torch.cat([data, parity], 1)
        inputs = units[:, valid].contiguous()
        matrix = torch.from_numpy(_decode_matrix(opts, valid, erased)).to(device)
        outs = [fused_kernel.fused_encode_crc(inputs, matrix, poly, bpc, crc_in=False),
                fused_kernel.fused_encode_crc_plain(inputs, matrix, poly, bpc, crc_in=False)]
        twin = fused._native_fused_decoder(opts, ChecksumType.CRC32C, bpc, tuple(valid),
                                           tuple(erased)).run(inputs)
        same = (all(torch.equal(twin[i], o[i].cpu()) for o in outs for i in (0, 1))
                and torch.equal(twin[0], units[:, erased].cpu()))
        print(f"host twin vs kernel and plain: {scheme} decode erased={erased} "
              f"matrix=[{len(erased)}, {len(valid)}] B={b}: {'exact' if same else 'DIFFERS'}")
        if not same:
            raise AssertionError(f"the host twin differs on {scheme} decode {erased}")
        n += 1
    spec = FusedSpec(CoderOptions(6, 3, "rs", cell_size=MIB), ChecksumType.CRC32, 16 * 1024)
    with env_set(OZONE_TPU_FUSED_BACKEND="native"):
        fn = fused.make_fused_encoder(spec, device=device)
    data = torch.from_numpy(rng.integers(0, 256, (2, 6, MIB), dtype=np.uint8)).to(device)
    fused_kernel.launches.reset()
    calls0 = fused.host_twin_calls.count
    fn(data)
    launched, calls = fused_kernel.launches.count, fused.host_twin_calls.count - calls0
    print(f"host path (b): under native a CRC32 spec stays on the card: {launched} launch, "
          f"{calls} twin calls")
    if launched != (device.type == "cuda") or calls:
        raise AssertionError("a CRC32 spec under native did not launch the kernel once")
    return n


def host_route_run(device, cluster: Cluster, route: str, what: str, fn) -> dict:
    """One run of `fn()` (returning user bytes) with OZONE_TPU_FUSED_BACKEND
    `route` ("native") or unset ("cuda"): GiB/s (wall), kernel launches,
    twin calls, the service's dispatches. On the CUDA route launches equal
    dispatches and the twin is not called; on the native route no kernel
    launches and every dispatch is one twin call."""
    from ozone_tpu_torch.codec import fused, fused_kernel

    env = {"OZONE_TPU_FUSED_BACKEND": "native" if route == "native" else "cuda"}
    with env_set(**env):
        before = service_counts()
        fused_kernel.launches.reset()
        fused.host_twin_calls.reset()
        t0 = time.perf_counter()
        nbytes = fn()
        wall = time.perf_counter() - t0
        launches, calls = fused_kernel.launches.count, fused.host_twin_calls.count
        svc = service_delta(before)
    rate = nbytes / wall / 2**30
    print(f"host path {what} ({route}): {nbytes} B in {wall:.3f} s = {rate:.3f} GiB/s (wall); "
          f"kernel launches {launches}, twin calls {calls}, service dispatches "
          f"{svc['dispatches']}")
    if svc["dispatches"] <= 0:
        raise AssertionError(f"{what} ({route}): no service dispatch")
    if route == "native" and (launches or calls != svc["dispatches"]):
        raise AssertionError(f"{what} (native): {launches} launches, {calls} twin calls "
                             f"for {svc['dispatches']} dispatches")
    if route == "cuda" and (calls or (device.type == "cuda"
                                      and launches != svc["dispatches"])):
        raise AssertionError(f"{what} (cuda): {launches} launches, {calls} twin calls "
                             f"for {svc['dispatches']} dispatches")
    return {"gib_s": rate, "launches": launches, "twin_calls": calls,
            "dispatches": svc["dispatches"]}


#: route order of host_path (c)'s pairs
HOST_ROUTES = ("native", "cuda") * 3


def host_pairs_step(device, cell: int, bpc: int, seed: int) -> dict:
    """(c) Alternating native and CUDA runs through the codec service: an
    RS(6,3) PUT of one 192 MiB key into 9 datanodes, read back exact; and
    an RS(10,4) degraded GET of a 96 MiB + 12 345 B key with units 0 and 1
    down, exact. {what: {route: [run, ...]}}."""
    from ozone_tpu_torch.codec.api import CoderOptions

    rng = np.random.default_rng(seed + 43)
    out = {"put": {"native": [], "cuda": []}, "degraded_get": {"native": [], "cuda": []}}
    rs63 = CoderOptions(6, 3, "rs", cell_size=cell)
    key = rng.integers(0, 256, 192 * MIB, dtype=np.uint8)
    for route in HOST_ROUTES:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-host-") as tmp:
            cluster = Cluster(Path(tmp), rs63, rs63.all_units)
            stored: list = []
            try:
                def put():
                    stored[:] = put_keys(cluster, [key], device, bpc)[0]
                    return key.size
                out["put"][route].append(
                    host_route_run(device, cluster, route, "RS(6,3) PUT of 192 MiB", put))
                read_groups(cluster, [key], stored, device, bpc)
            finally:
                cluster.close()
    rs104 = CoderOptions(10, 4, "rs", cell_size=cell)
    key = rng.integers(0, 256, 96 * MIB + 12345, dtype=np.uint8)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-host-") as tmp:
        cluster = Cluster(Path(tmp), rs104, rs104.all_units)
        try:
            groups, _ = put_keys(cluster, [key], device, bpc)
            cluster.dead = {groups[0][0].pipeline.nodes[u] for u in (0, 1)}

            def get():
                read = read_groups(cluster, [key], groups, device, bpc)
                if not read["dispatches"]:
                    raise AssertionError("the degraded GET decoded nothing")
                return read["bytes"]

            for route in HOST_ROUTES:
                out["degraded_get"][route].append(host_route_run(
                    device, cluster, route, "RS(10,4) degraded GET (units 0, 1 down)", get))
        finally:
            cluster.close()
    for what, runs in out.items():
        rates = {route: " ".join(f"{r['gib_s']:.3f}" for r in rs)
                 for route, rs in runs.items()}
        print(f"host path (c) {what} GiB/s by route: "
              + ", ".join(f"{route} {r}" for route, r in rates.items()))
    return out


def host_mesh_step(device, cell: int, bpc: int, seed: int, slots: int = 4) -> dict:
    """(d) A MeshExecutor on `slots` logical slots of the card under
    OZONE_TPU_FUSED_BACKEND=native: an RS(6,3) encode and an RS(10,4)
    decode key resolve to the host twin on every slot (programs_host_twin
    >= 2), launch nothing, and equal the single-device kernel."""
    from ozone_tpu_torch.codec import fused, fused_kernel
    from ozone_tpu_torch.codec import service as codec_service
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import FusedSpec, _decode_matrix, _parity_matrix
    from ozone_tpu_torch.parallel import mesh_executor, sharded
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY, ChecksumType

    rng = np.random.default_rng(seed + 47)
    rs63, rs104 = CoderOptions(6, 3, "rs", cell_size=cell), CoderOptions(10, 4, "rs", cell_size=cell)
    valid, erased = list(range(2, 12)), [0, 1]
    jobs = [(codec_service.encode_key(FusedSpec(rs63, ChecksumType.CRC32C, bpc)),
             rng.integers(0, 256, (8, 6, cell), dtype=np.uint8), _parity_matrix(rs63), True),
            (codec_service.decode_key(FusedSpec(rs104, ChecksumType.CRC32C, bpc), valid,
                                      erased),
             rng.integers(0, 256, (8, 10, cell), dtype=np.uint8),
             _decode_matrix(rs104, valid, erased), False)]
    with env_set(OZONE_TPU_FUSED_BACKEND="native"):
        ex = mesh_executor.MeshExecutor(mesh=sharded.make_mesh(devices=[device] * slots),
                                        depth=2)
        try:
            fused_kernel.launches.reset()
            forms0 = sum(c.count for c in sharded.launches.values())
            calls0 = fused.host_twin_calls.count
            results = [ex.submit(key, stripes, width=2).result(timeout=120)
                       for key, stripes, _, _ in jobs]
            ex.quiesce()
            launched = (fused_kernel.launches.count
                        + sum(c.count for c in sharded.launches.values()) - forms0)
            calls = fused.host_twin_calls.count - calls0
            stats = ex.stats()
        finally:
            ex.close()
    for (key, stripes, m, crc_in), got in zip(jobs, results):
        t = torch.from_numpy(stripes).to(device)
        want = fused_kernel.fused_encode_crc(t, torch.from_numpy(m).to(device), CRC32C_POLY,
                                             bpc, crc_in)
        if not (np.array_equal(got[0], want[0].cpu().numpy())
                and np.array_equal(got[1], want[1].cpu().numpy().view(np.uint32))):
            raise AssertionError(f"mesh host twin {key[0]} differs from the kernel")
    print(f"host path (d) mesh executor under native on {slots} logical slots: "
          f"programs {stats['programs']}, programs_host_twin {stats['programs_host_twin']}, "
          f"kernel launches {launched}, twin calls {calls}; encode and decode equal to the "
          "single-device kernel")
    if stats["programs_host_twin"] < 2 or launched:
        raise AssertionError(f"mesh host twin: {stats['programs_host_twin']} twin programs, "
                             f"{launched} launches")
    return {"programs_host_twin": stats["programs_host_twin"], "twin_calls": calls}


def host_auto_step(device, cell: int, bpc: int, seed: int, verdict: str) -> dict:
    """(e) One RS(6,3) PUT of 96 MiB + 12 345 B under
    OZONE_TPU_FUSED_BACKEND=auto: its launches follow (a)'s encode verdict
    (the kernel: launches equal dispatches; the twin: no launch)."""
    from ozone_tpu_torch.codec import fused, fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions

    rng = np.random.default_rng(seed + 53)
    rs63 = CoderOptions(6, 3, "rs", cell_size=cell)
    key = rng.integers(0, 256, 96 * MIB + 12345, dtype=np.uint8)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-host-") as tmp, \
            env_set(OZONE_TPU_FUSED_BACKEND="auto"):
        cluster = Cluster(Path(tmp), rs63, rs63.all_units)
        try:
            before = service_counts()
            fused_kernel.launches.reset()
            fused.host_twin_calls.reset()
            groups, _ = put_keys(cluster, [key], device, bpc)
            launches, calls = fused_kernel.launches.count, fused.host_twin_calls.count
            svc = service_delta(before)
            read_groups(cluster, [key], groups, device, bpc)
        finally:
            cluster.close()
    print(f"host path (e) PUT under auto (verdict {verdict}): kernel launches {launches}, "
          f"twin calls {calls}, service dispatches {svc['dispatches']}; read back exact")
    want = ((svc["dispatches"] if device.type == "cuda" else 0, 0) if verdict == "cuda"
            else (0, svc["dispatches"]))
    if not svc["dispatches"] or (launches, calls) != want:
        raise AssertionError(f"PUT under auto: launches {launches}, twin calls {calls} for "
                             f"{svc['dispatches']} dispatches and verdict {verdict}")
    return {"launches": launches, "twin_calls": calls}


def host_path(device, cell: int, bpc: int, seed: int, cases, decode_cases) -> dict:
    """The host coding backend (`codec/fused.py`'s twin and policy): (a)
    the probe and the `auto` verdicts, (b) the twin exact against the
    kernel and its plain version, (c) native/CUDA pairs of a PUT and a
    degraded GET through the codec service, (d) the mesh executor's host
    twin, (e) a PUT under `auto` following (a)'s verdict. Every step
    fails the run on a mismatch."""
    out = {"probe": host_probe_step(cell)}
    out["twin_cases"] = host_twin_cases(device, cases, decode_cases, seed)
    out["pairs"] = host_pairs_step(device, cell, bpc, seed)
    out["mesh"] = host_mesh_step(device, cell, bpc, seed)
    out["auto"] = host_auto_step(device, cell, bpc, seed,
                                 out["probe"]["verdicts"][HOST_VERDICTS[0][0]])
    out["launches"] = {
        "host_put_cuda": sum(r["launches"] for r in out["pairs"]["put"]["cuda"]),
        "host_degraded_get_cuda": sum(
            r["launches"] for r in out["pairs"]["degraded_get"]["cuda"]),
        "host_auto_put": out["auto"]["launches"],
    }
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-only", action="store_true",
                    help="build, kernel cases and timings only; no main paths")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build, kernel cases and timings, then mesh_path only")
    ap.add_argument("--host-only", action="store_true",
                    help="build, kernel cases and timings, then host_path only")
    ap.add_argument("--mesh-worker", nargs=3, metavar=("RANK", "PORT", "DEVICE"),
                    help=argparse.SUPPRESS)  # one rank of mesh_path's two-process run
    args = ap.parse_args()
    if args.mesh_worker:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        rank, port, dev = args.mesh_worker
        return mesh_worker(int(rank), int(port), dev)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from ozone_tpu_torch import cuda_build  # fails outside a checkout

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    # the encryption path's host libraries: a missing one fails the run
    print(f"crypto check: {crypto_check()}")
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for lib, (secs, log) in sorted(logs.items()):
        print(f"compile {lib} ({secs:.2f} s):\n{log.strip()}")
    from ozone_tpu_torch.utils import checksum

    probe = checksum.native_probe()
    print(f"host CRC32C: route {checksum.route()}, native_probe() = {probe} "
          "(1 = SSE4.2 crc32, 2 = AVX2 build, 0 = bitwise loop, -1 = numpy)")
    if checksum.route() != "native" or probe < 1:
        raise AssertionError("the host CRC32C library is not on the SSE4.2 route")
    from ozone_tpu_torch.codec import cpp_coder

    print(f"host GF coder: probe() = {cpp_coder.probe()} (2 = AVX2, 0 = scalar loop)")
    if cpp_coder.probe() < 2:
        raise AssertionError("the host GF coder is not the AVX2 build")

    from ozone_tpu_torch.codec import fused_kernel

    for k, p in ((6, 3), (10, 4), (20, 4)):
        smem, per_sm = fused_kernel.kernel_occupancy(k, p, 16 * 1024, k + p)
        print(f"fused_encode_crc rs-{k}-{p} bpc=16384: {smem} B shared memory per "
              f"block, {per_sm} blocks per SM")
    bpc = 16 * 1024
    cases = [
        (6, 3, MIB, bpc, 8, "CRC32C"),
        (6, 3, MIB, bpc, 8, "CRC32"),
        (10, 4, MIB, bpc, 4, "CRC32C"),
        (3, 2, MIB, MIB, 4, "CRC32C"),  # one slice per cell, many tiles
        (6, 3, MIB, bpc, 1, "NONE"),
        (20, 4, MIB, bpc, 2, "CRC32C"),
        (6, 3, 4800, 480, 3, "CRC32C"),  # 512-byte tile, padded front
        (6, 3, 4800, 100, 3, "CRC32"),  # slice not a multiple of 16: byte path
        (6, 3, MIB, bpc, 4, "CRC32C", False),  # decode form: outputs only
        (6, 0, MIB, bpc, 4, "CRC32C"),  # p = 0: plain slice CRC
        (12, 4, MIB, bpc, 8, "CRC32C", True, "lrc-12-2-2"),  # LRC encode, [4, 12]
        (1, 0, bpc, bpc, 4096, "CRC32C"),  # the scrubber's batch at its 64 MiB cap
        (1, 0, bpc, bpc, 1024, "CRC32C"),  # the scrub of one 16 MiB container
        (6, 1, MIB, bpc, 8, "CRC32C", True, "xor-6-1"),  # XOR encode, [1, 6]
        (6, 3, MIB, bpc, 16, "CRC32C"),  # the tiering window, W = 16
    ]
    err = check_kernel_cases(device, cases, args.seed)
    from ozone_tpu_torch.codec import lrc_math
    from ozone_tpu_torch.codec.api import CoderOptions

    def lrc_read_set(erased):
        return lrc_math.plan_valid(CoderOptions.parse("lrc-12-2-2"), erased,
                                   [u for u in range(16) if u not in erased])[0]

    decode_cases = [  # (scheme, valid, erased, cell, bpc, B, checksum)
        ("rs-10-4", list(range(2, 12)), [0, 1], MIB, bpc, 8, "CRC32C"),
        ("rs-6-3", [0, 1, 3, 4, 5, 6], [2, 7], MIB, bpc, 8, "CRC32C"),
        ("rs-10-4", [0, 1, 2, 4, 5, 6, 7, 8, 9, 13], [3], MIB, bpc, 1, "CRC32C"),
        ("rs-10-4", list(range(4, 14)), [0, 1, 2, 3], MIB, bpc, 2, "NONE"),
        # LRC local repair: [1, 6], the register-held k = 6 instance
        ("lrc-12-2-2", lrc_read_set([2]), [2], MIB, bpc, 8, "CRC32C"),
        # one loss in each group: [2, 12]
        ("lrc-12-2-2", lrc_read_set([2, 8]), [2, 8], MIB, bpc, 8, "CRC32C"),
        # global: two data units and their group's local parity, pruned columns
        ("lrc-12-2-2", lrc_read_set([0, 1, 12]), [0, 1, 12], MIB, bpc, 8, "CRC32C"),
    ]
    err = max(err, check_decode_cases(device, decode_cases, args.seed))
    # the XOR(1)->RS re-encode form: [4, 6], crc_in and crc_out
    err = max(err, check_reencode_cases(device, (0, 2, 5), MIB, bpc, 8, args.seed))
    timed = time_kernel(device, 6, 3, MIB, bpc, 8, args.seed, plain=True)
    time_kernel(device, 6, 3, MIB, bpc, 128, args.seed, plain=False)
    time_parts(device, 6, 3, MIB, bpc, 128, args.seed)
    decode = time_decode(device, MIB, bpc, 8, args.seed)
    forms = time_lrc_and_scrub(device, MIB, bpc, args.seed)
    forms["reencode"] = time_reencode(device, MIB, bpc, 8, args.seed)
    # the lifecycle executor's window: [16, 6, 1 MiB] with all nine CRC rows
    forms["tier_window"] = time_kernel(device, 6, 3, MIB, bpc, 16, args.seed, plain=True)
    forms["tier_window"].pop("bound_by")
    print("library_ms: none; no single PyTorch call computes a GF(2^8) "
          "matrix apply with slice CRCs")
    # the raw coder SPI's forms: no CRC rows
    coder_err = check_coder_forms(device, MIB, args.seed)
    coder_timed = time_coder_forms(device, MIB, args.seed)

    launches = paths = None
    phase_s = {"build_and_kernel_cases": time.perf_counter() - t_start}

    def phase(name, fn, *a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            phase_s[name] = time.perf_counter() - t

    mesh = None
    if args.mesh_only or args.host_only:
        if args.mesh_only:
            mesh = phase("mesh_path", mesh_path, device, MIB, bpc, args.seed)
            paths = dict(mesh["launches"])
        else:
            paths = dict(phase("host_path", host_path, device, MIB, bpc, args.seed, cases,
                               decode_cases)["launches"])
        launches = sum(paths.values())
        form_launches = {"gf_apply": None, "xor_reduce": None}
        print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
              + f"; total {time.perf_counter() - t_start:.1f}")
    elif not args.kernel_only:
        put = phase("main_path", main_path, device,
                    [192 * MIB, 192 * MIB, 96 * MIB + 12345, MIB + 7], MIB, bpc, args.seed)
        small = phase("small_puts", small_puts, device, 32, 6 * MIB + 4096, MIB, bpc,
                      args.seed)
        rr = phase("read_repair_path", read_repair_path, device,
                   [320 * MIB, 161 * MIB + 12345], MIB, bpc, args.seed)
        lrc = phase("lrc_path", lrc_path, device, [384 * MIB, MIB + 12345], MIB, bpc,
                    args.seed)
        cp = phase("control_plane_path", control_plane_path, device, MIB, bpc, args.seed)
        fr = phase("freon_path", freon_path, device, MIB, bpc, args.seed)
        dm = phase("daemon_path", daemon_path, device, MIB, bpc, args.seed,
                   statistics.mean(r["gib_s"] for r in put["service"]))
        # depth cuts for the later phases' room (PERF.md section 4): one S3
        # client of four
        s3 = phase("s3_path", s3_path, device, MIB, bpc, args.seed, 1)
        # depth cut: 2 big keys of 16
        lc = phase("lifecycle_path", lifecycle_path, device, MIB, bpc, args.seed, 2)
        # depth cut: 64 keys per tinyg run and 16 on the stripe path, of the
        # cell's 2000 and 500
        so = phase("small_object_path", small_object_path, device, MIB, bpc, args.seed,
                   64, 64 * 1024, 16)
        # depth cut: (a) and (d) take 2 keys of 8, (b) 8 keys of 16, (c) 4 of 8
        ha = phase("ha_path", ha_path, device, MIB, bpc, args.seed, 2, 64 * MIB, 8,
                   n_ratis=4)
        # depth cuts: (a) 4 files of 8, (c) 40 files per thread of 500 (listed
        # in pages of 25, of 100), (f) 16 files of 128
        fs = phase("fs_path", fs_path, device, MIB, bpc, args.seed, n_io=4,
                   md_files=40, md_page=25, n_small=16)
        # depth cut: one user per tenant of two
        sec = phase("security_path", security_path, device, MIB, bpc, args.seed, 2, 1)
        # depth cuts: one big key of four, 4 ranged GETs of 16, 2 renewal
        # rounds of 6
        enc = phase("encryption_path", encryption_path, device, MIB, bpc, args.seed,
                    n_big=1, n_ranged=4, n_renew=2)
        adm = phase("scm_admin_path", scm_admin_path, device, MIB, bpc, args.seed)
        snap = phase("snapshot_path", snapshot_path, device, MIB, bpc, args.seed)
        # depth cuts for chaos_path's room: geo 8 log keys (of 16) and a
        # freon geo of 6 keys (of 12); shard ommg 300 ops (of 600) and 300
        # keys over shardd (of 600)
        geo = phase("geo_path", geo_path, device, MIB, bpc, args.seed, n_logs=8,
                    freon_keys=6)
        # depth cut for ops_path's room: omkg 600 keys in process (of 1500)
        shard = phase("shard_path", shard_path, device, MIB, bpc, args.seed,
                      omkg_keys=600, ommg_ops=300, shardd_keys=300)
        ops = phase("ops_path", ops_path, device, MIB, bpc, args.seed)
        # depth cuts for mesh_path's room: 12 s of chaos writes (of 20) and
        # om_scale at 40 000 keys (of 100 000)
        chaos = phase("chaos_path", chaos_path, device, MIB, bpc, args.seed, chaos_s=12.0,
                      om_scale_keys=40_000)
        mesh = phase("mesh_path", mesh_path, device, MIB, bpc, args.seed)
        host = phase("host_path", host_path, device, MIB, bpc, args.seed, cases,
                     decode_cases)
        print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
              + f"; total {time.perf_counter() - t_start:.1f}")
        paths = {
            f"rs63_{name}_{route}": sum(r["launches"] for r in runs[route])
            for name, runs in (("put", put), ("small_puts", small))
            for route in ("service", "direct", "warmup")}
        paths.update({
            "rs104_put": rr["put_launches"], "rs104_decode": rr["decode_launches"],
            "lrc_put": lrc["put_launches"], "lrc_decode": lrc["decode_launches"],
            "scrub": lrc["scrub"]["launches"],
            "control_plane_xor_put": cp["put_launches"],
            "reencode_replicated": cp["reencode_replicated"]["launches"],
            "reencode_xor": cp["reencode_xor"]["launches"],
            "reencode_xor_parity_lost": cp["reencode_xor_parity_lost"]["launches"],
            "scm_repair": cp["repair_launches"],
            "control_plane_degraded_get": cp["degraded_launches"],
            "rawcoder_bench": fr["rawcoder"]["launches"],
            "freon_ockg": fr["ockg_launches"], "freon_ockv": fr["ockv_launches"],
            "freon_ockrr": fr["ockrr_launches"], "freon_ecrd": fr["ecrd_launches"],
            "storm": fr["storm_launches"],
            "daemon_put": dm["put_launches"],
            "daemon_put_rpc_lane": dm["put_rpc_launches"],
            "daemon_degraded_get": dm["degraded_launches"],
            "daemon_repair": dm["repair_launches"],
            "daemon_scrub": dm["scrub_launches"],
            **s3["launches"], "s3g_process": dm["cli"]["s3g"]["launches"],
            "lifecycle_tier": lc["tier_launches"],
            "lifecycle_xor_reencode": lc["xor_launches"],
            "lifecycle_daemon_run_now": lc["daemon_launches"],
            **so["launches"], **ha["launches"], **fs["launches"],
            **sec["launches"], **enc["launches"], **adm["launches"],
            **snap["launches"], **geo["launches"], **shard["launches"],
            **ops["launches"], **chaos["launches"], **mesh["launches"],
            **host["launches"],
        })
        launches = sum(paths.values())
        form_launches = {form: fr["rawcoder"][f"{form}_launches"]
                         for form in ("gf_apply", "xor_reduce")}
        print(f"kernel launches on the main paths: {launches} {paths}; of them "
              f"through the coder SPI's forms {form_launches}")
    else:
        form_launches = {"gf_apply": None, "xor_reduce": None}
    from ozone_tpu_torch.codec import service as codec_service

    codec_service.reset_for_tests()  # stops the service's dispatcher thread
    print(json.dumps({"kernels": [{
        "name": "fused_encode_crc", "route": "cuda",
        "source": "ozone_tpu_torch/csrc/fused_encode_crc.cu",
        "replaces": "ozone_tpu/codec/pallas_kernel.py:56",
        "launches": launches, "max_abs_err": err,
        "ms": timed["ms"], "ms_in_run": timed["ms_in_run"], "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
        "library_ms": None,
        "decode_ms": decode["ms"], "decode_ms_in_run": decode["ms_in_run"],
        "decode_plain_ms": decode["plain_ms"], "decode_bound_ms": decode["bound_ms"],
        **{f"{form}_{key}": value for form, timing in forms.items()
           for key, value in timing.items()},
        "launches_by_path": paths,
    }] + [{
        "name": f"fused_encode_crc as {form} (no CRC rows)", "route": "cuda",
        "source": "ozone_tpu_torch/csrc/fused_encode_crc.cu",
        "replaces": replaces, "launches": form_launches[form],
        "max_abs_err": coder_err[form], "ms": coder_timed[form]["ms"],
        "ms_in_run": coder_timed[form]["ms_in_run"],
        "plain_ms": coder_timed[form]["plain_ms"],
        "bound_ms": coder_timed[form]["bound_ms"],
        "bound_by": coder_timed[form]["bound_by"], "library_ms": None,
    } for form, replaces in (("gf_apply", "ozone_tpu/codec/jax_coder.py:108"),
                             ("xor_reduce", "ozone_tpu/codec/jax_coder.py:177"))]
        + (mesh_kernel_entries(mesh) if mesh is not None else [])}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
