# ozlint: path ozone_tpu_torch/net/_fixture.py
"""Known-bad corpus for `error-swallowing`: silently dropped datapath
exceptions — a loud failure converted into silent loss."""


def apply_entry(store, entry):
    try:
        store.apply(entry)
    except Exception:
        pass  # swallowed: the replica silently diverges


def read_frame(sock):
    try:
        return sock.recv(4096)
    except:  # bare except: even KeyboardInterrupt vanishes
        return b""
