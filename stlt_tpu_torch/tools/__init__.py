"""The port's tools, run as ``python -m stlt_tpu_torch.tools.<name>``:
``dump_features`` and ``dump_perbox_features`` (R3D features into HDF5) and
``verify_checkpoints`` (a model zoo's manifest through ``inference``). Each
keeps its compute apart from its HDF5 writes, so the compute runs where
h5py is absent."""

from __future__ import annotations

import contextlib

STAGING = "_staging"


@contextlib.contextmanager
def features_file(path: str):
    """The features file opened for appending, and the ids already written
    in it. The groups a cut run left half written (under ``_staging``) are
    removed on entry, and the staging group on a clean exit."""
    import h5py

    out = h5py.File(path, "a", libver="latest")
    try:
        if STAGING in out:
            del out[STAGING]
        yield out, set(out.keys())
        if STAGING in out:
            del out[STAGING]
    finally:
        out.close()


def write_video_group(out, video_id: str, datasets) -> None:
    """Write one video's datasets (name -> array) under ``video_id``: staged
    in a group of their own and moved into place once all are written, so a
    run cut between them leaves no half-written group that a resumed run
    would skip."""
    group = out.require_group(STAGING).create_group(video_id)
    for name, data in datasets.items():
        group.create_dataset(name, data=data)
    out.move(f"{STAGING}/{video_id}", video_id)
