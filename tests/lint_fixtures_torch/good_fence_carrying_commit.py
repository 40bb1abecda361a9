# ozlint: path ozone_tpu_torch/lifecycle/_fixture.py
"""Known-good corpus for `fence-carrying-commit`: every fenced mutation
carries its term / expected object id."""
from ozone_tpu_torch.om import requests as rq


def expire_key(om, volume, bucket, key, info):
    om.submit(rq.DeleteKey(volume, bucket, key,
                           expect_object_id=info["object_id"]))


def commit_converted(om, session, groups, size, info):
    om.submit(rq.CommitKey(
        session.volume, session.bucket, session.key,
        session.client_id, size, groups,
        expect_object_id=info["object_id"]))


def checkpoint_cursor(om, term, cursor):
    om.submit(rq.LifecycleCheckpoint(term, cursor=cursor, stats={}))
