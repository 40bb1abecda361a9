# ozlint: path ozone_tpu_torch/client/native_dn.py
"""Known-bad corpus for `datapath-no-copy`: payload bytes materialized
on a wire-facing datapath module — each shape doubles the memory
traffic of the chunk that crosses it."""
import numpy as np


def recv_frame(conn):
    tag, body = conn.recv(5), conn.recv_body()
    return tag, bytes(body)  # materializes the whole payload


def send_frames(sock, frames):
    sock.sendall(b"".join(bytes(f) for f in frames))


def read_chunk(payload):
    return np.frombuffer(payload, dtype=np.uint8).copy()


def pack_chunk(arr):
    return arr.tobytes()
