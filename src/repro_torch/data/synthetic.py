"""Synthetic Ali-CCP-style click log: the materialized world of the
offline experiment (``build_world``, the user split, CTR batches) and
the streamed request world of serving (``StreamingWorld``).

A latent-utility model generates structurally-faithful traffic:

  * users: latent taste z_u in R^dl, activity a_u ~ heavy-tailed lognormal
    (the paper's "users with varying levels of activity" whose reward
    curves differ - the property GreenFlow exploits);
  * items: latent z_i, popularity pop_i ~ zipf-ish, category from a
    clustering of z_i;
  * click model: p(u clicks i) = sigmoid(s * <z_u, z_i> + pop_i + b_u)
    with activity entering through b_u - active users click more and
    saturate earlier (=> concave reward curves with different slopes);
  * per-user behavior history sampled proportional to affinity;
  * categorical user/item features are quantized projections of the
    latents (so models CAN learn preferences from ids).

Everything is generated lazily from a seed - the 85M-sample scale of
Ali-CCP is samplable without materializing it.  NumPy only: the device
side of the port reads the arrays this module produces.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class WorldConfig:
    n_users: int = 20_000
    n_items: int = 4_000
    n_cats: int = 50
    d_latent: int = 16
    hist_len: int = 50
    n_user_fields: int = 4
    user_field_vocab: int = 64  # per-field quantization buckets
    click_scale: float = 4.0
    click_bias: float = -2.0
    seed: int = 0


@dataclass
class World:
    cfg: WorldConfig
    z_user: np.ndarray  # (U, dl)
    z_item: np.ndarray  # (I, dl)
    activity: np.ndarray  # (U,) in (0, inf), heavy tailed
    popularity: np.ndarray  # (I,)
    item_cat: np.ndarray  # (I,) int
    user_fields: np.ndarray  # (U, F) int
    hist_ids: np.ndarray  # (U, T) int
    hist_mask: np.ndarray  # (U, T) float

    # ---- click ground truth -------------------------------------------------
    def click_prob(self, users: np.ndarray, items: np.ndarray) -> np.ndarray:
        """users (B,), items (B,) or (B, N) -> p(click)."""
        cfg = self.cfg
        zu = self.z_user[users]
        if items.ndim == 1:
            zi = self.z_item[items]
            aff = np.einsum("bd,bd->b", zu, zi)
            pop = self.popularity[items]
        else:
            zi = self.z_item[items]
            aff = np.einsum("bd,bnd->bn", zu, zi)
            pop = self.popularity[items]
        act = np.log1p(self.activity[users])
        # heterogeneous preference SHARPNESS (the paper's premise: users
        # differ in how much ranking quality matters): active users click
        # by affinity (good rankers pay off), casual users click diffusely
        # (cheap chains suffice) - this is what GreenFlow exploits.
        sharp = cfg.click_scale * (0.35 + 1.3 * np.tanh(self.activity[users]))
        if items.ndim == 2:
            act = act[:, None]
            sharp = sharp[:, None]
        logits = sharp * aff + pop + act + cfg.click_bias
        return 1.0 / (1.0 + np.exp(-logits))

    def sample_clicks(self, users, items, rng: np.random.Generator):
        return (rng.random(items.shape) < self.click_prob(users, items)) \
            .astype(np.float32)

    def reward_context(self, users: np.ndarray) -> np.ndarray:
        """Per-request context features f_i for the reward model:
        activity (log + saturating tanh, the preference-sharpness driver),
        history length, field one-hot hashes, taste norm."""
        act = np.log1p(self.activity[users])[:, None]
        sharp = np.tanh(self.activity[users])[:, None]
        hl = self.hist_mask[users].sum(-1, keepdims=True) / self.cfg.hist_len
        fields = self.user_fields[users] / self.cfg.user_field_vocab
        taste = np.abs(self.z_user[users])  # coarse taste signature
        return np.concatenate([act, sharp, hl, fields, taste],
                              -1).astype(np.float32)

    @property
    def d_context(self) -> int:
        return 3 + self.cfg.n_user_fields + self.cfg.d_latent


def build_world(cfg: WorldConfig = WorldConfig()) -> World:
    rng = np.random.default_rng(cfg.seed)
    z_user = rng.normal(size=(cfg.n_users, cfg.d_latent)) / np.sqrt(cfg.d_latent)
    z_item = rng.normal(size=(cfg.n_items, cfg.d_latent)) / np.sqrt(cfg.d_latent)
    activity = rng.lognormal(mean=0.0, sigma=1.0, size=cfg.n_users)
    popularity = -np.log(1.0 + np.arange(cfg.n_items) / 50.0)
    popularity = popularity - popularity.mean()
    rng.shuffle(popularity)

    # categories = k-means-ish hash of item latents
    proto = rng.normal(size=(cfg.n_cats, cfg.d_latent))
    item_cat = np.argmax(z_item @ proto.T, axis=1).astype(np.int64)

    # user categorical fields: quantized random projections of taste
    proj = rng.normal(size=(cfg.d_latent, cfg.n_user_fields))
    q = z_user @ proj
    ranks = np.argsort(np.argsort(q, axis=0), axis=0) / cfg.n_users
    user_fields = np.minimum((ranks * cfg.user_field_vocab).astype(np.int64),
                             cfg.user_field_vocab - 1)
    # field id spaces are disjoint per field
    user_fields += np.arange(cfg.n_user_fields) * cfg.user_field_vocab

    # histories: affinity-proportional sampling, length ~ activity
    aff = z_user @ z_item.T + popularity[None, :]
    hist_ids = np.zeros((cfg.n_users, cfg.hist_len), np.int64)
    hist_mask = np.zeros((cfg.n_users, cfg.hist_len), np.float32)
    lengths = np.clip((activity / activity.max() * cfg.hist_len * 2).astype(int),
                      3, cfg.hist_len)
    gumbel = rng.gumbel(size=aff.shape)
    order = np.argsort(-(aff * 3.0 + gumbel), axis=1)
    for u in range(cfg.n_users):
        t = lengths[u]
        hist_ids[u, :t] = order[u, :t]
        hist_mask[u, :t] = 1.0

    return World(cfg, z_user, z_item, activity, popularity, item_cat,
                 user_fields, hist_ids, hist_mask)


# ---------------------------------------------------------------------------
# Streaming world: users as a pure function of (seed, user id)
# ---------------------------------------------------------------------------
#
# A materialized world holds every user up front - including a (U, I)
# affinity matrix for histories and population-rank field quantization -
# which caps it at a few thousand users.  The streaming variant keeps
# the SAME latent-utility click model and O(I) item side but derives
# each user row from a counter-based hash RNG (splitmix64 -> uniforms ->
# Box-Muller), so ANY slice of an unbounded user universe materializes
# on demand in O(n * I), independent of cfg.n_users: rank quantization
# becomes Gaussian-CDF quantization (same distribution, per-user
# computable) and the history Gumbel noise is keyed per (user, item).
# It is a DIFFERENT (larger) world than a materialized one for the same
# config - bitwise parity across the two generators is neither needed
# nor claimed; streamed-vs-materialized serving parity is tested on
# replay sources that share one world.


_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_GAMMA = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: a bijective avalanche on uint64 (overflow
    IS the mod-2^64 arithmetic, so the warning is silenced)."""
    x = np.asarray(x).astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= _M1
        x ^= x >> np.uint64(27)
        x *= _M2
        x ^= x >> np.uint64(31)
    return x


def _hash_u64(seed: int, *streams) -> np.ndarray:
    """Counter-based uint64 hash of (seed, *streams) - broadcasting.

    Each stream is folded in through the splitmix64 finalizer, so any
    coordinate change avalanches the output; streams broadcast against
    each other (e.g. ``(ids[:, None], dims[None, :])`` -> (n, d))."""
    with np.errstate(over="ignore"):
        x = _mix64(np.uint64(seed) + _GAMMA)
        for k, s in enumerate(streams):
            s = np.asarray(s, np.uint64)
            x = _mix64(x ^ (s * _GAMMA + np.uint64(2 * k + 1)))
    return x


def _hash_u01(seed: int, *streams) -> np.ndarray:
    """Uniforms in [2^-53, 1): the top 53 bits of the hash."""
    u = (_hash_u64(seed, *streams) >> np.uint64(11)).astype(np.float64)
    return np.maximum(u * (2.0 ** -53), 2.0 ** -53)


def _hash_normal(seed: int, *streams) -> np.ndarray:
    """Standard normals via Box-Muller on two hashed uniform draws
    (sub-stream ids 0/1 appended to the key)."""
    u1 = _hash_u01(seed, *streams, 0)
    u2 = _hash_u01(seed, *streams, 1)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


# hash key sub-stream ids (the leading stream of every per-user draw)
_H_TASTE, _H_ACT, _H_HIST, _H_CLICK = 11, 12, 13, 14

# activity reference for history length (~97.7th pct of lognormal(0,1));
# a materialized world uses the realized population max, which a lazy generator
# cannot see - a fixed distributional reference replaces it
_ACT_REF = float(np.exp(2.0))


@dataclass
class StreamingWorld:
    """Unbounded-U lazy world: the item side of ``World`` plus per-user
    generation on demand.

    ``user_slab(ids)`` returns a regular ``World`` whose arrays hold
    exactly those users under LOCAL indices 0..n-1 (``click_prob``,
    ``reward_context`` and the cascade-model feature batches all run on
    the slab unchanged), and ``clicks_slab(ids)`` samples the (n, I)
    ground-truth click realization - keyed per (user, item), so a user
    arriving in two windows sees the same clicks, exactly like the
    materialized world's once-per-(user, item) sampling.
    """

    cfg: WorldConfig
    z_item: np.ndarray  # (I, dl)
    popularity: np.ndarray  # (I,)
    item_cat: np.ndarray  # (I,) int
    field_proj: np.ndarray  # (dl, F) field projections
    field_sigma: np.ndarray  # (F,) per-field projection std

    @classmethod
    def build(cls, cfg: WorldConfig) -> "StreamingWorld":
        """O(I) item side from its own seed stream (independent of U)."""
        rng = np.random.default_rng((cfg.seed, 0xC0FFEE))
        z_item = rng.normal(size=(cfg.n_items, cfg.d_latent)) \
            / np.sqrt(cfg.d_latent)
        popularity = -np.log(1.0 + np.arange(cfg.n_items) / 50.0)
        popularity = popularity - popularity.mean()
        rng.shuffle(popularity)
        proto = rng.normal(size=(cfg.n_cats, cfg.d_latent))
        item_cat = np.argmax(z_item @ proto.T, axis=1).astype(np.int64)
        proj = rng.normal(size=(cfg.d_latent, cfg.n_user_fields))
        # z_user ~ N(0, I/dl), so q_f = z @ proj_f ~ N(0, |proj_f|^2/dl)
        sigma = np.linalg.norm(proj, axis=0) / np.sqrt(cfg.d_latent)
        return cls(cfg, z_item, popularity, item_cat, proj, sigma)

    @property
    def d_context(self) -> int:
        return 3 + self.cfg.n_user_fields + self.cfg.d_latent

    def user_slab(self, ids: np.ndarray) -> World:
        """Materialize exactly these users as a World (local indices)."""
        from scipy.special import ndtr  # Phi, vectorized
        cfg = self.cfg
        ids = np.asarray(ids, np.int64)
        z = _hash_normal(cfg.seed, _H_TASTE, ids[:, None],
                         np.arange(cfg.d_latent)[None, :]) \
            / np.sqrt(cfg.d_latent)
        activity = np.exp(_hash_normal(cfg.seed, _H_ACT, ids))
        # Gaussian-CDF quantization: same marginal as a materialized world's
        # population ranks, but a pure per-user function
        q = ndtr((z * np.sqrt(cfg.d_latent)) @ self.field_proj
                 / (self.field_sigma[None, :] * np.sqrt(cfg.d_latent)))
        user_fields = np.minimum((q * cfg.user_field_vocab).astype(np.int64),
                                 cfg.user_field_vocab - 1)
        user_fields += np.arange(cfg.n_user_fields) * cfg.user_field_vocab
        # histories: affinity-proportional, Gumbel keyed per (user, item)
        aff = z @ self.z_item.T + self.popularity[None, :]
        gum = -np.log(-np.log(_hash_u01(
            cfg.seed, _H_HIST, ids[:, None],
            np.arange(cfg.n_items)[None, :])))
        order = np.argsort(-(aff * 3.0 + gum), axis=1, kind="stable")
        lengths = np.clip((activity / _ACT_REF * cfg.hist_len * 2)
                          .astype(int), 3, cfg.hist_len)
        hist_ids = order[:, :cfg.hist_len].astype(np.int64)
        hist_mask = (np.arange(cfg.hist_len)[None, :]
                     < lengths[:, None]).astype(np.float32)
        hist_ids[hist_mask == 0.0] = 0
        return World(cfg, z, self.z_item, activity, self.popularity,
                     self.item_cat, user_fields, hist_ids, hist_mask)

    def clicks_slab(self, ids: np.ndarray, slab: World | None = None,
                    pad_rows: int | None = None) -> np.ndarray:
        """(n, I) ground-truth clicks, keyed per (user, item).

        ``pad_rows`` returns a (pad_rows, I) array with zero rows past
        ``len(ids)`` - the chunk-padded layout the device table builder
        consumes, written once instead of computed then copied."""
        cfg = self.cfg
        ids = np.asarray(ids, np.int64)
        n = len(ids)
        slab = slab if slab is not None else self.user_slab(ids)
        items = np.broadcast_to(np.arange(cfg.n_items),
                                (n, cfg.n_items))
        p = slab.click_prob(np.arange(n), items)
        u = _hash_u01(cfg.seed, _H_CLICK, ids[:, None],
                      np.arange(cfg.n_items)[None, :])
        if pad_rows is None:
            return (u < p).astype(np.float32)
        out = np.zeros((pad_rows, cfg.n_items), np.float32)
        np.less(u, p, out=out[:n])
        return out


# ---------------------------------------------------------------------------
# Paper split (§5.1): 50% cascade-model train / 25% validation /
# 22.5% reward-model sample generation / 2.5% final eval.  At mini scale
# a 2.5% eval slice is a handful of users and the realized-revenue
# comparisons drown in click noise, so ``fracs`` is configurable; the
# experiment harness shifts mass from validation (unused offline) to the
# final-eval slice (as the JAX package does).
# ---------------------------------------------------------------------------


@dataclass
class UserSplit:
    cascade_train: np.ndarray
    validation: np.ndarray
    reward_train: np.ndarray
    final_eval: np.ndarray


PAPER_SPLIT = (0.5, 0.25, 0.225, 0.025)


def split_users(world: World, seed: int = 1,
                fracs: tuple = PAPER_SPLIT) -> UserSplit:
    if len(fracs) != 4 or abs(sum(fracs) - 1.0) > 1e-6:
        raise ValueError(f"fracs must be 4 fractions summing to 1: {fracs}")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(world.cfg.n_users)
    n = world.cfg.n_users
    a = int(fracs[0] * n)
    b = a + int(fracs[1] * n)
    c = b + int(fracs[2] * n)
    return UserSplit(perm[:a], perm[a:b], perm[b:c], perm[c:])


def ctr_batch(world: World, users: np.ndarray, rng: np.random.Generator,
              batch: int) -> dict:
    """Pointwise CTR training batch (for DIN/DIEN/BST-style rankers)."""
    u = rng.choice(users, size=batch)
    items = rng.integers(0, world.cfg.n_items, size=batch)
    y = world.sample_clicks(u, items, rng)
    return {
        "user_fields": world.user_fields[u].astype(np.int32),
        "hist_ids": world.hist_ids[u].astype(np.int32),
        "hist_cats": world.item_cat[world.hist_ids[u]].astype(np.int32),
        "hist_mask": world.hist_mask[u],
        "item_id": items.astype(np.int32),
        "item_cat": world.item_cat[items].astype(np.int32),
        "label": y,
        "users": u,
    }
