"""Sharded co-visitation counting: shard_map + all-to-all count exchange.

The multi-host story of the reference is Dask task shuffles
(reference: dask_utils.py:9-32, SURVEY.md §5.8). Here the same dataflow is
SPMD: every device counts pairs over its session shard (data parallelism ==
the reference's chunked outer loop, model/count_co_events.py:83), then an
ALL-TO-ALL exchanges compressed (key, aid_next, count) triples so that each
device owns the disjoint key range {aid : aid % n_shards == shard_id} — the
hierarchical merge (model/count_co_events.py:103-181) becomes a single
collective + local sort-compress merge, over the device interconnect
instead of disk.

Like the single-chip CoVisCounter, all 5 count types ride ONE type-tagged
keyspace (k1 = type * AID_STRIDE + aid; the types are disjoint in
(type_this, type_next), reference: config.py:81-88): one compress, one
exchange and one merge per step instead of five — 5x less collective
volume. Ownership is by the UNTAGGED aid ((k1 % AID_STRIDE) % n_shards),
so every count type's row for an aid lives on the same shard — the layout
retrieval-table building wants.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from otto_tpu.ops import counts as counts_ops
from otto_tpu.ops import pairs as pairs_ops
from otto_tpu.ops import segment as seg
from otto_tpu.ops.counts import CountTable
from otto_tpu.ops.pairs import AID_STRIDE

SENT = seg.SENTINEL


def _exchange_by_owner(ua, ub, uc, n_shards: int, axis: str):
    """Route compressed pair triples to their owner shard
    ((k1 % AID_STRIDE) % n_shards) via all_to_all. Inputs are per-device [P]
    arrays (SENTINEL padded); output: [n_shards * P] arrays of triples this
    shard owns."""
    Pn = ua.shape[0]
    valid = (ua != SENT) & (uc > 0)
    owner = jnp.where(valid, (ua % AID_STRIDE) % n_shards, n_shards - 1)

    # sort by owner; compute within-owner position via segment starts
    owner_s, a_s, b_s, c_s = jax.lax.sort(
        (owner, ua, ub, uc), num_keys=1, is_stable=True
    )
    pos = jnp.arange(Pn, dtype=jnp.int32)
    starts = seg.segment_starts(owner_s)
    slot = pos - starts

    # scatter into [n_shards, P] send buffers (slot < P always: at most P
    # entries total per device)
    send_a = jnp.full((n_shards, Pn), SENT, jnp.int32).at[owner_s, slot].set(a_s)
    send_b = jnp.full((n_shards, Pn), SENT, jnp.int32).at[owner_s, slot].set(b_s)
    send_c = jnp.zeros((n_shards, Pn), jnp.int32).at[owner_s, slot].set(c_s)
    # re-mask invalid lanes that sorted to the tail of their owner bucket
    pad = send_a == SENT
    send_c = jnp.where(pad, 0, send_c)

    recv_a = jax.lax.all_to_all(send_a, axis, 0, 0, tiled=False)
    recv_b = jax.lax.all_to_all(send_b, axis, 0, 0, tiled=False)
    recv_c = jax.lax.all_to_all(send_c, axis, 0, 0, tiled=False)
    return recv_a.reshape(-1), recv_b.reshape(-1), recv_c.reshape(-1)


def make_sharded_covis_update(
    plan: pairs_ops.CoVisPlan,
    mesh: Mesh,
    axis: str = "data",
):
    """Build the jitted sharded update:
      (table_sharded, aid [S, L], ts, type) -> table_sharded
    where the single type-tagged table's rows are sharded over `axis` (each
    shard's rows form an independent CountTable owning
    (k1 % AID_STRIDE) % n == shard_id) and the session batch is sharded over
    the same axis."""
    if not pairs_ops.plan_types_disjoint(plan):
        raise ValueError("tagged sharded counting requires disjoint count types")
    n = mesh.shape[axis]

    def per_shard(table: CountTable, aid, ts, type_, sess):
        k1, k2, m = pairs_ops.emit_pairs_tagged(aid, ts, type_, plan, sess=sess)
        # map-side combine shrinks the all-to-all volume
        ua, ub, uc, _ = seg.sort_compress(k1, k2, m.astype(jnp.int32))
        ra, rb, rc = _exchange_by_owner(ua, ub, uc, n, axis)
        # local combine of the received triples before the big merge
        ca, cb, cc, _ = seg.sort_compress(ra, rb, rc)
        # per-shard n is a length-1 vector (the sharded [n_shards] field)
        t = table._replace(n=table.n[0])
        t = counts_ops.merge_into_impl(t, ca, cb, cc)
        return t._replace(n=t.n.reshape(1))

    table_spec = CountTable(aid=P(axis), aid_next=P(axis), count=P(axis), n=P(axis))

    @partial(jax.jit, donate_argnums=(0,))
    def update(table, aid, ts, type_, sess):
        in_specs = (
            table_spec, P(axis, None), P(axis, None), P(axis, None),
            P(axis, None),
        )
        fn = shard_map(
            per_shard, mesh=mesh, in_specs=in_specs, out_specs=table_spec,
            check_vma=False,
        )
        return fn(table, aid, ts, type_, sess)

    return update


def make_sharded_table(capacity_per_shard: int, mesh: Mesh,
                       axis: str = "data") -> CountTable:
    """Allocate the type-tagged count table with rows sharded over `axis`.
    The global row count is n_shards * capacity_per_shard; shard k owns keys
    with (k1 % AID_STRIDE) % n_shards == k. The per-shard `n` scalar becomes
    a length-n_shards vector under sharding."""
    n = mesh.shape[axis]
    sh_rows = NamedSharding(mesh, P(axis))
    return CountTable(
        aid=jax.device_put(
            jnp.full((n * capacity_per_shard,), SENT, jnp.int32), sh_rows
        ),
        aid_next=jax.device_put(
            jnp.full((n * capacity_per_shard,), SENT, jnp.int32), sh_rows
        ),
        count=jax.device_put(
            jnp.zeros((n * capacity_per_shard,), jnp.int32), sh_rows
        ),
        n=jax.device_put(jnp.zeros((n,), jnp.int32), sh_rows),
    )


def gather_tagged_table(table: CountTable, names) -> Dict[str, tuple]:
    """Pull the sharded tagged table to host, split by type tag: since
    shards own disjoint key ranges, concatenation gives the global counts.
    Returns {count_type_name: (aid, aid_next, count)} sorted by key."""
    import numpy as np

    a = np.asarray(table.aid)
    b = np.asarray(table.aid_next)
    c = np.asarray(table.count)
    valid = (a != int(SENT)) & (c > 0)
    a, b, c = a[valid], b[valid], c[valid]
    tag = a // AID_STRIDE
    out = {}
    for i, name in enumerate(names):
        m = tag == i
        ai, bi, ci = a[m] - i * AID_STRIDE, b[m], c[m]
        order = np.lexsort((bi, ai))
        out[name] = (ai[order], bi[order], ci[order])
    return out
