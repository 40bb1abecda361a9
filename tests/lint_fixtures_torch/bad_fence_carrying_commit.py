# ozlint: path ozone_tpu_torch/lifecycle/_fixture.py
"""Known-bad corpus for `fence-carrying-commit`: ring mutations of
term-fenced state issued WITHOUT their fencing field — a deposed
leader's late commit or a background job racing a user overwrite."""
from ozone_tpu_torch.om import requests as rq


def expire_key(om, volume, bucket, key):
    # background delete with no rewrite fence: destroys a concurrent
    # user overwrite instead of losing to it
    om.submit(rq.DeleteKey(volume, bucket, key))


def commit_converted(om, session, groups, size):
    om.submit(rq.CommitKey(
        session.volume, session.bucket, session.key,
        session.client_id, size, groups))  # no expect_object_id


def checkpoint_cursor(om, cursor):
    # no `term`: a deposed sweeper's stale cursor could regress the scan
    om.submit(rq.LifecycleCheckpoint(cursor=cursor, stats={}))
