"""Decodes with the item batch split over the mesh's ranks.

Counterpart of `vsrcic_tpu/parallel/sharded.py`. JAX's `shard_map` runs the
whole single-device program, Pallas kernels included, on each device's
block with no collective. Here each rank runs the port's own single-device
decode on its block (the fused attention and vocab top-k kernels among it,
at the block's row count) and one `all_gather` per result field puts the
blocks back in the batch's order on every rank. The captioner must be on the
mesh's device.
"""
from __future__ import annotations

from vsrcic_tpu_torch.decode.beam import BeamResult
from vsrcic_tpu_torch.parallel.mesh import (DataMesh, all_gather_blocks,
                                            same_device)


def _block(mesh: DataMesh, captioner, b: int):
    if not same_device(captioner.device, mesh.device):
        raise ValueError("the captioner runs on %s, this rank on %s"
                         % (captioner.device, mesh.device))
    if b % mesh.size:
        raise ValueError("batch %d not divisible by data axis %d"
                         % (b, mesh.size))
    return slice(*mesh.bounds(b))


def sharded_beam_search_v(captioner, mesh: DataMesh, detections, det_groups,
                          verb_list, eos_word: int, beam_size: int = 5,
                          gt: bool = False) -> BeamResult:
    """beam_search_v with the item batch split over the ranks; the batch
    must divide by the mesh's size (pad upstream). Every rank gets the
    whole BeamResult, as the single-device call returns it."""
    blk = _block(mesh, captioner, detections.shape[0])
    res = captioner.beam_search_v(detections[blk], det_groups[blk],
                                  verb_list[blk], eos_word=eos_word,
                                  beam_size=beam_size, gt=gt)
    return BeamResult(*(all_gather_blocks(f, mesh) for f in res))


def sharded_greedy(captioner, mesh: DataMesh, detections, det_groups):
    """The greedy decode (`ControllableCaptioner.test`) with the batch
    split over the ranks: (words, gates) of the whole batch."""
    blk = _block(mesh, captioner, detections.shape[0])
    return tuple(all_gather_blocks(x, mesh) for x in captioner.test(
        detections[blk], det_groups[blk]))
