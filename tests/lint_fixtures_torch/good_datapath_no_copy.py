# ozlint: path ozone_tpu_torch/client/native_dn.py
"""Known-good corpus for `datapath-no-copy`: payloads travel as views;
control-plane materializations carry a reasoned suppression; size
preallocations are not copies."""
import json

import numpy as np


def recv_frame(conn):
    tag, body = conn.recv(5), conn.recv_body()
    return tag, memoryview(body)  # view over the pooled recv buffer


def send_frames(sock, views):
    sock.sendmsg([memoryview(v) for v in views])  # gathered, no join


def read_chunk(payload):
    return np.frombuffer(payload, dtype=np.uint8)  # zero-copy view


def parse_status(body):
    # a STATUS frame is tens of bytes of JSON, not payload
    return json.loads(bytes(body))  # ozlint: allow[datapath-no-copy] -- control-plane STATUS JSON, not payload


def make_scratch():
    return bytes(4096)  # size preallocation, nothing copied
