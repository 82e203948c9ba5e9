"""Small host-side utilities (the port of
``chainermn_tpu/utils/__init__.py``).

Only :func:`ensure_batch_fits` is ported. The reference's
``apply_env_platform``, ``axis_size`` and ``pcast_varying`` are not:
each works around a JAX mechanism (plugin-forced platforms, the
``lax.axis_size`` gap of old JAX, shard_map's varying-manner casts) that
a PyTorch program does not have.
"""

from __future__ import annotations


def ensure_batch_fits(dataset, global_batch: int, size: int = 1) -> None:
    """Fail fast when the batch exceeds the dataset: every batch would be
    a ragged tail (which training loops skip, matching the reference's
    drop-last behaviour) and zero steps would run. One process a rank
    checks its own batch against its own shard.

    ``size`` is the rank count when the batch was computed as per-rank
    batch x ranks (used only for the error message)."""
    if global_batch > len(dataset):
        how = f" (= per-rank batch x {size} ranks)" if size > 1 else ""
        raise SystemExit(
            f"batch {global_batch}{how} exceeds the "
            f"{len(dataset)}-sample dataset: every batch would be a ragged "
            "tail and zero training steps would run")


__all__ = ["ensure_batch_fits"]
