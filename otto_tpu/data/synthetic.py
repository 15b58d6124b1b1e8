"""Synthetic OTTO-like session generator.

The Kaggle dataset is not redistributable and is absent from this environment,
so the framework ships a generator producing sessions with the same schema and
the same *learnable structure* the reference pipeline exploits
(reference: README.md:9-18 scale; SURVEY.md §6 scale constants):

* zipf item popularity           -> popularity retrieval signal (C12)
* latent item categories with
  within-category transitions    -> co-visitation + w2vec signal (C7, C8)
* item revisits within a session -> the 'self' source (model/retrieve.py:259)
* click -> cart -> order funnel  -> type-conditioned co-count matrices

Sessions are generated fully vectorized over a [S, L] grid.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from functools import partial

import numpy as np

from otto_tpu.data.schema import Events

log = logging.getLogger(__name__)

DAY = 24 * 60 * 60


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    n_sessions: int = 10_000
    n_aids: int = 20_000
    max_len: int = 64
    mean_len: float = 15.0
    cat_size: int = 50           # latent category size
    zipf_a: float = 1.2          # popularity skew
    p_revisit: float = 0.25      # next event revisits an earlier session item
    p_neighbor: float = 0.45     # next event stays within the latent category
    p_cart: float = 0.10         # a click upgrades to a cart
    p_order_after_cart: float = 0.25  # a carted item later produces an order
    span_days: int = 28          # dataset time span
    seed: int = 0


def _zipf_draw(rng: np.random.Generator, spec: SyntheticSpec, size) -> np.ndarray:
    """Item ids with zipf popularity; id == popularity rank."""
    u = rng.random(size)
    # inverse-CDF of a truncated zipf via power transform (cheap, adequate)
    ranks = (spec.n_aids ** (u ** spec.zipf_a)).astype(np.int64) - 1
    return np.clip(ranks, 0, spec.n_aids - 1).astype(np.int32)


def generate(spec: SyntheticSpec) -> Events:
    rng = np.random.default_rng(spec.seed)
    S, L = spec.n_sessions, spec.max_len

    # latent categories via a fixed permutation of the item space
    perm = rng.permutation(spec.n_aids).astype(np.int32)
    perm_inv = np.argsort(perm).astype(np.int32)

    lengths = np.clip(
        rng.lognormal(np.log(spec.mean_len), 0.7, S).astype(np.int32), 2, L
    )

    aid = np.zeros((S, L), np.int32)
    typ = np.zeros((S, L), np.int8)
    carted = np.full((S, 4), -1, np.int32)  # ring buffer of carted aids
    n_carted = np.zeros(S, np.int32)

    aid[:, 0] = _zipf_draw(rng, spec, S)

    for t in range(1, L):
        u = rng.random(S)
        cur = aid[:, t - 1]

        # neighbour jump within latent category
        slot = perm[cur] // spec.cat_size * spec.cat_size + rng.integers(
            0, spec.cat_size, S
        )
        nbr = perm_inv[np.clip(slot, 0, spec.n_aids - 1)]

        # revisit an earlier item of the session
        back = rng.integers(0, t, S)
        prev = aid[np.arange(S), back]

        fresh = _zipf_draw(rng, spec, S)

        nxt = np.where(
            u < spec.p_revisit,
            prev,
            np.where(u < spec.p_revisit + spec.p_neighbor, nbr, fresh),
        )
        aid[:, t] = nxt

        # types: click by default; upgrade to cart; carted items may order
        is_cart = rng.random(S) < spec.p_cart
        can_order = n_carted > 0
        is_order = (rng.random(S) < spec.p_order_after_cart) & can_order & ~is_cart
        typ[:, t] = np.where(is_cart, 1, np.where(is_order, 2, 0)).astype(np.int8)

        # an order re-targets a previously carted item
        pick = rng.integers(0, 4, S) % np.maximum(n_carted, 1)
        ordered_aid = carted[np.arange(S), pick]
        aid[:, t] = np.where(is_order, ordered_aid, aid[:, t])

        # push carts into the ring buffer
        ring_pos = n_carted % 4
        carted[is_cart, ring_pos[is_cart]] = aid[is_cart, t]
        n_carted = n_carted + is_cart.astype(np.int32)

    # timestamps: session start uniform over the span, exp gaps (median ~1min)
    start = rng.integers(0, spec.span_days * DAY, S)[:, None]
    gaps = rng.exponential(90.0, (S, L)).astype(np.int64) + 1
    ts = (start + np.cumsum(gaps, axis=1)).astype(np.int32)

    # flatten honoring per-session lengths
    mask = np.arange(L)[None, :] < lengths[:, None]
    session_ids = np.broadcast_to(
        np.arange(S, dtype=np.int32)[:, None], (S, L)
    )
    ev = Events(
        session=session_ids[mask],
        aid=aid[mask],
        ts=ts[mask],
        type=typ[mask],
    )
    return ev.sort_by_session_ts()


def generate_device(
    spec: SyntheticSpec,
    chunk_sessions: int = 1 << 21,
    backend: str | None = None,
) -> Events:
    """`generate()` rebuilt as a device program: the sequential per-step
    session walk becomes a `lax.scan` over the L time steps with the [S, L]
    aid/type grids as scan carries (XLA aliases the `dynamic_update_slice`
    in place), and the ragged flatten happens ON DEVICE via a stable
    sort-by-validity so only the flat event columns (~13 B/event) ever
    cross the host link — not the padded grids (~9x larger).

    Rationale: the host NumPy generator is single-core and the largest
    fixed cost of a reference-scale run (12.9M sessions / 220M events);
    the device walk is a short program. Same latent structure and knobs as
    `generate()` (zipf popularity, category transitions, revisits,
    click->cart->order funnel), different RNG stream (threefry vs PCG64) —
    use a fresh work dir, not byte-compatible with host-generated caches.

    All per-row updates are scatter-free (one-hot blends / gathers only,
    the design rule of ops/segment.py). Emission order is (session, ts)-sorted by
    construction, so no 220M-row host lexsort afterwards either.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax, random

    rng = np.random.default_rng(spec.seed)
    L = spec.max_len
    perm = rng.permutation(spec.n_aids).astype(np.int32)
    perm_inv = np.argsort(perm).astype(np.int32)
    dev = jax.local_devices(backend=backend)[0]
    permd = jax.device_put(jnp.asarray(perm), dev)
    perm_invd = jax.device_put(jnp.asarray(perm_inv), dev)

    n_aids_f = float(spec.n_aids)

    def zipf(k, shape):
        u = random.uniform(k, shape)
        r = jnp.exp(jnp.log(n_aids_f) * (u ** spec.zipf_a)).astype(jnp.int32) - 1
        return jnp.clip(r, 0, spec.n_aids - 1)

    # permd/perm_invd enter as ARGUMENTS: closing over them bakes 2 x n_aids
    # int32 constants into the jaxpr, which defeats the persistent compile
    # cache (a fresh compile per process launch)
    def gen_chunk(permd, perm_invd, key, S):
        ks = random.split(key, 5)
        lengths = jnp.clip(
            jnp.exp(jnp.log(spec.mean_len)
                    + 0.7 * random.normal(ks[0], (S,))).astype(jnp.int32),
            2, L,
        )
        aid0 = zipf(ks[1], (S,))
        aid_buf = jnp.zeros((S, L), jnp.int32).at[:, 0].set(aid0)
        typ_buf = jnp.zeros((S, L), jnp.int8)
        carted = jnp.full((S, 4), -1, jnp.int32)
        n_carted = jnp.zeros((S,), jnp.int32)
        rows = jnp.arange(S)

        def step(carry, t):
            key, aid_buf, typ_buf, carted, n_carted = carry
            key, k1, k2, k3, k4, k5, k6, k7 = random.split(key, 8)
            u = random.uniform(k1, (S,))
            cur = lax.dynamic_slice_in_dim(aid_buf, t - 1, 1, axis=1)[:, 0]

            slot = (permd[cur] // spec.cat_size * spec.cat_size
                    + random.randint(k2, (S,), 0, spec.cat_size))
            nbr = perm_invd[jnp.clip(slot, 0, spec.n_aids - 1)]

            # revisit: uniform earlier position (t is a traced scalar)
            back = (random.uniform(k3, (S,)) * t).astype(jnp.int32)
            prev = jnp.take_along_axis(
                aid_buf, back[:, None], axis=1
            )[:, 0]

            fresh = zipf(k4, (S,))
            nxt = jnp.where(
                u < spec.p_revisit,
                prev,
                jnp.where(u < spec.p_revisit + spec.p_neighbor, nbr, fresh),
            )

            is_cart = random.uniform(k5, (S,)) < spec.p_cart
            can_order = n_carted > 0
            is_order = ((random.uniform(k6, (S,)) < spec.p_order_after_cart)
                        & can_order & ~is_cart)
            typ_t = jnp.where(is_cart, 1, jnp.where(is_order, 2, 0)).astype(
                jnp.int8
            )

            # an order re-targets a previously carted item
            pick = random.randint(k7, (S,), 0, 4) % jnp.maximum(n_carted, 1)
            ordered_aid = jnp.take_along_axis(
                carted, pick[:, None], axis=1
            )[:, 0]
            nxt = jnp.where(is_order, ordered_aid, nxt)

            # ring-buffer push as a one-hot blend (no scatter)
            ring_pos = n_carted % 4
            push = is_cart[:, None] & (
                jnp.arange(4)[None, :] == ring_pos[:, None]
            )
            carted = jnp.where(push, nxt[:, None], carted)
            n_carted = n_carted + is_cart.astype(jnp.int32)

            aid_buf = lax.dynamic_update_slice(aid_buf, nxt[:, None], (0, t))
            typ_buf = lax.dynamic_update_slice(
                typ_buf, typ_t[:, None], (0, t)
            )
            return (key, aid_buf, typ_buf, carted, n_carted), None

        (key, aid_buf, typ_buf, _, _), _ = lax.scan(
            step,
            (key, aid_buf, typ_buf, carted, n_carted),
            jnp.arange(1, L),
        )

        k_start, k_gap = random.split(key)
        start = random.randint(
            k_start, (S, 1), 0, spec.span_days * DAY
        )
        gaps = (-90.0 * jnp.log(random.uniform(
            k_gap, (S, L), minval=1e-12, maxval=1.0
        ))).astype(jnp.int32) + 1
        ts_buf = (start + jnp.cumsum(gaps, axis=1)).astype(jnp.int32)

        # device-side ragged flatten: stable sort rows by invalidity so the
        # valid events land at the front IN (session, ts) ORDER, then the
        # host pulls exactly n_valid rows of each flat column
        valid = jnp.arange(L)[None, :] < lengths[:, None]
        sess = jnp.broadcast_to(rows[:, None].astype(jnp.int32), (S, L))
        inv = (~valid).ravel().astype(jnp.int8)
        _, fs, fa, ft, fy = lax.sort(
            (inv, sess.ravel(), aid_buf.ravel(), ts_buf.ravel(),
             typ_buf.ravel()),
            num_keys=1,
            is_stable=True,
        )
        return fs, fa, ft, fy, jnp.sum(valid.astype(jnp.int32))

    gen_jit = jax.jit(gen_chunk, static_argnums=(3,), backend=backend)

    # static-size prefix slice: fs[:n] with a dynamic n is a fresh compile
    # PER DISTINCT n (4 arrays x per chunk); rounding n up to a power of two
    # keeps the program count at ~1 per chunk shape
    @partial(jax.jit, static_argnums=(1,), backend=backend)
    def _prefix(x, size):
        return x[:size]

    base = random.key(spec.seed)
    out_s, out_a, out_t, out_y = [], [], [], []
    done = 0
    ci = 0
    t0 = time.time()
    while done < spec.n_sessions:
        S_want = min(chunk_sessions, spec.n_sessions - done)
        # ALWAYS generate a full-size chunk and drop the surplus sessions on
        # the host: sessions are independent, and a second program shape for
        # the tail chunk costs another compile
        S = min(chunk_sessions, spec.n_sessions)
        fs, fa, ft, fy, n = gen_jit(permd, perm_invd, random.fold_in(base, ci), S)
        n = int(n)
        size = min(fs.shape[0], max(1024, 1 << (n - 1).bit_length()))
        cs = np.asarray(_prefix(fs, size))[:n]
        if S_want < S:  # flat columns are session-sorted: one searchsorted
            n = int(np.searchsorted(cs, S_want))
            cs = cs[:n]
        out_s.append(cs + np.int32(done))
        out_a.append(np.asarray(_prefix(fa, size))[:n])
        out_t.append(np.asarray(_prefix(ft, size))[:n])
        out_y.append(np.asarray(_prefix(fy, size))[:n])
        done += S_want
        ci += 1
        log.info(
            "generate_device: %d/%d sessions (%d events, %.1fs)",
            done, spec.n_sessions, sum(len(x) for x in out_a), time.time() - t0,
        )
    return Events(
        session=np.concatenate(out_s),
        aid=np.concatenate(out_a),
        ts=np.concatenate(out_t),
        type=np.concatenate(out_y),
    )
