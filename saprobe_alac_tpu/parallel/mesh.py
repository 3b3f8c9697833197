"""Packet-axis data parallelism over a device mesh.

ALAC packets are fully self-contained (own headers, own coefficients, decoder
state reset per packet — reference decode.go:130-187), so multi-chip scaling
is pure data parallelism: shard the batch axis over the mesh and run the
single-chip pipeline per shard under jax.shard_map.  No collectives are
required for correctness (SURVEY §2.4); the only cross-device traffic is the
optional output gather, which rides NVLink via the output sharding.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import PacketConfig
from ..ops.batch import JaxBatchDecoder, _bucket, _decode_batch
from ..ops.bitpack import pack_packets


PACKET_AXIS = "packets"


def make_packet_mesh(devices: Sequence[jax.Device] | None = None) -> Mesh:
    """A 1-D mesh with every device on the packet axis."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (PACKET_AXIS,))


class ShardedBatchDecoder(JaxBatchDecoder):
    """Batch decoding sharded over a device mesh (packet-axis DP)."""

    def __init__(self, config: PacketConfig, mesh: Mesh | None = None, impl: str | None = None):
        super().__init__(config, impl=impl)
        self.mesh = mesh if mesh is not None else make_packet_mesh()
        self._n = self.mesh.devices.size
        cfg = self.config
        single = partial(
            _decode_batch,
            frame_length=cfg.frame_length,
            num_channels=cfg.num_channels,
            depth=cfg.bit_depth,
            pb=cfg.pb,
            mb=cfg.mb,
            kb=cfg.kb,
            impl=self.impl,
        )
        sharded = jax.shard_map(
            single,
            mesh=self.mesh,
            in_specs=(P(PACKET_AXIS, None), P(PACKET_AXIS)),
            out_specs=(P(PACKET_AXIS, None), P(PACKET_AXIS), P(PACKET_AXIS)),
            # Loop carries are seeded from replicated literals; skip the
            # varying-manual-axes check (everything here is lane-local).
            check_vma=False,
        )
        self._fn = jax.jit(sharded)

    def decode_async(self, packets: Sequence[bytes]):
        words_np, sizes_np = pack_packets(list(packets))
        B = len(packets)
        n = self._n
        Bb = max(_bucket(B), n)
        Bb = ((Bb + n - 1) // n) * n  # divisible by mesh size
        Wb = _bucket(words_np.shape[1], floor=16)
        words = np.zeros((Bb, Wb), dtype=np.int32)
        words[:B, : words_np.shape[1]] = words_np
        sizes = np.zeros(Bb, dtype=np.int32)
        sizes[:B] = sizes_np

        # Each shard goes straight from host memory to its own device.
        words_d = jax.device_put(words, NamedSharding(self.mesh, P(PACKET_AXIS, None)))
        sizes_d = jax.device_put(sizes, NamedSharding(self.mesh, P(PACKET_AXIS)))
        return self._fn(words_d, sizes_d)
