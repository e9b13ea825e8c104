"""Multi-device scale-out on ``torch.distributed``: the counterpart of
``hla_la_tpu/parallel/mesh.py`` (XLA ``shard_map`` steps there, collectives
around the port's own kernels here).

The reference has no distributed backend — its parallelism is OpenMP over
allele-cluster pairs (HLATyper.cpp:2293-2364) and thread-ready (but serial)
per-read loops (SURVEY.md §2.3).  The replacement, with the reference
package's two axes:

  * axis "data"  — reads are i.i.d. work items; NW batches and the reads of
    the [C, R] likelihood matrix shard across it; per-pair partial sums are
    reduced with an all-reduce.
  * axis "model" — allele clusters shard across it: the rows of the cluster
    x read product, and the tiles of the O(C^2 R) pair reduction.

No parameter sharding is ever needed: the "model" (graph + allele matrices)
is replicated per rank.

Controller model.  JAX drives every device from one process;
``torch.distributed`` is one process per rank.  Here every rank runs the
same entry point on the same inputs: host stages are repeated on every rank
(they are deterministic), the device stages below are split, and every
function returns the gathered result on every rank.  Rank r of a mesh is
(data r // n_model, model r % n_model).  A run's ranks form one mesh, with
the model axis that ``model_axis`` derives from their count as the reference
package does from its device count; NW batches split over all of them
(``Mesh.all_data``), the pair reduction over both axes.

Each rank's share goes through the port's own forward and difference term:
K1/K2 and K3 when the rank's device is a card, the plain versions on the
CPU.  K3 covers the c1 <= c2 tiles of one matrix, so a model rank takes a
range of K3's tile list (better balanced than row blocks of a triangle);
the contract is the gathered result.  Partials are summed over ranks in
float64, so n ranks stay as close to one rank as K3's own split of the
reads does.

Collectives run where the group's backend can: NCCL on the ranks' cards
(one card per rank), gloo on host tensors (CPU ranks, or several ranks on
one card, where a rank computes on the card and its results cross through
the host).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve, to_device
from ..ops.banded_nw import DEFAULT_SCORING, banded_nw_forward_torch
from ..ops.pair_ll import LOG_HALF, _pair_ll_diff, pair_tiles

RENDEZVOUS_TIMEOUT_S = 300


def init_ranks(rank: int, world_size: int, init_method: str,
               device: str | torch.device,
               timeout_s: float = RENDEZVOUS_TIMEOUT_S) -> torch.device:
    """Join the default process group and return this rank's device.  On
    "cuda" a rank takes card rank % device_count; the backend is NCCL when
    every rank has a card of its own, else gloo (NCCL refuses two ranks on
    one card).  "cpu" is gloo.  A rank that does not arrive within
    `timeout_s` fails the others instead of hanging them."""
    dev = resolve(device)
    backend = "gloo"
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", rank % n_cards)
        torch.cuda.set_device(dev)
        if world_size <= n_cards:
            backend = "nccl"
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def close_ranks() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclass
class Mesh:
    """A data x model grid over the ranks of the default process group."""

    shape: dict              # {"data": n_data, "model": n_model}
    rank: int
    data_index: int
    model_index: int
    device: torch.device     # where this rank computes
    model_group: object      # the ranks of this rank's data index
    data_group: object       # the ranks of this rank's model index
    host_collectives: bool   # gloo: tensors cross on the host

    def staged(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host_collectives else t.to(self.device)

    def all_data(self) -> "Mesh":
        """The same ranks as one "data" axis, the mesh the aligner splits
        its NW batches over (the reference aligner's make_mesh(n, 1))."""
        return Mesh({"data": dist.get_world_size(), "model": 1}, self.rank,
                    self.rank, 0, self.device, None, dist.group.WORLD,
                    self.host_collectives)

    def all_gather(self, t: torch.Tensor, group) -> torch.Tensor:
        """Every rank's `t` (equal shapes) of `group`, joined along the
        first axis in rank order; on the host under gloo.  `group` None:
        this rank alone."""
        x = self.staged(t).contiguous()
        if group is None:
            return x
        outs = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(outs, x, group=group)
        return torch.cat(outs)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `t` over all ranks."""
        x = self.staged(t).contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x


def model_axis(n_ranks: int) -> int:
    """Ranks along "model" for a run of `n_ranks`, the reference package's
    rule for its device count (hla_la_tpu/parallel/mesh.py,
    pair_ll_reduction_sharded): 2 for an even count above 2, else 1."""
    return 2 if n_ranks % 2 == 0 and n_ranks > 2 else 1


def make_mesh(n_data: int, n_model: int = 1, *,
              device: str | torch.device) -> Mesh:
    """The mesh of the initialised default group, whose size must be
    n_data * n_model.  `device`: where this rank computes (what init_ranks
    returned); the group's backend only says where tensors cross."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.mesh.init_ranks)")
    world = dist.get_world_size()
    need = n_data * n_model
    assert world == need, f"need {need} ranks, have {world}"
    rank = dist.get_rank()
    d_i, m_i = divmod(rank, n_model)
    # every rank makes every group, in one order
    model_group = data_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == d_i:
            model_group = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == m_i:
            data_group = g
    nccl = dist.get_backend() == "nccl"
    return Mesh({"data": n_data, "model": n_model}, rank, d_i, m_i,
                resolve(device), model_group, data_group, not nccl)


def _share(n: int, i: int, parts: int) -> tuple[int, int]:
    """[lo, hi) of part i when n items are cut into `parts` even parts."""
    return n * i // parts, n * (i + 1) // parts


def _local_ll(mesh: Mesh, onehot: np.ndarray, contrib: np.ndarray
              ) -> torch.Tensor:
    """LL of every cluster with this rank's read shard, [C, R/d] on the
    rank's device: the rows of the rank's model share by a local product,
    all-gathered over "model"."""
    C = onehot.shape[0]
    m = mesh.shape["model"]
    rows = -(-C // m)
    lo, hi = _share(contrib.shape[0], mesh.data_index, mesh.shape["data"])
    mine = np.zeros((rows, onehot.shape[1]), dtype=np.float32)
    own = onehot[mesh.model_index * rows:(mesh.model_index + 1) * rows]
    mine[:len(own)] = own
    A = to_device(mine, mesh.device)
    B = to_device(np.ascontiguousarray(contrib[lo:hi], dtype=np.float32),
                  mesh.device)
    ll_l = torch.matmul(A, B.T)                          # [C/m, R/d]
    return mesh.all_gather(ll_l, mesh.model_group)[:C].to(mesh.device)


def _pair_from_ll(mesh: Mesh, ll: torch.Tensor,
                  rowsum: torch.Tensor | None = None) -> np.ndarray:
    """[C, C] float64 pair log-likelihoods from this rank's [C, R/d] read
    shard: the difference term of the rank's share of the tile list, the
    rank-1 term (from `rowsum` [C] float64 of the shard, default: of `ll`)
    and the per-read constant once per data index, summed over all ranks in
    float64."""
    C = ll.shape[0]
    t_lo, t_hi = _share(pair_tiles(C), mesh.model_index, mesh.shape["model"])
    if ll.shape[1]:
        acc, rpad = _pair_ll_diff(ll.contiguous(), (t_lo, t_hi - t_lo))
        part = acc.to(torch.float64)
    else:
        part, rpad = torch.zeros((C, C), dtype=torch.float64), 0
    part = mesh.staged(part)
    if mesh.model_index == 0:
        # zero-padded reads add log 2 each to the difference term and
        # LOG_HALF each here: the sum of the ranks' padded counts cancels
        if rowsum is None:
            rowsum = ll.to(torch.float64).sum(dim=1)
        rowsum = mesh.staged(rowsum)
        part = part + 0.5 * (rowsum[:, None] + rowsum[None, :]) \
            + LOG_HALF * rpad
    return mesh.all_reduce(part).cpu().numpy()


def pair_marginal(pair: np.ndarray) -> np.ndarray:
    """REAL pair-posterior marginal (HLATyper.cpp:2409-2538): softmax over
    the UNORDERED pairs (upper triangle incl. diagonal — the full symmetric
    matrix would count every heterozygous pair twice in the normaliser,
    inflating het-pair posteriors), marginal per cluster = mass of every
    pair containing it (diagonal once)."""
    C = pair.shape[0]
    triu = np.arange(C)[:, None] <= np.arange(C)[None, :]
    post = np.where(triu, np.exp(pair - pair.max()), 0.0)
    post = post / post.sum()
    return post.sum(axis=1) + post.sum(axis=0) - np.diag(post)


def sharded_typing_step(mesh: Mesh):
    """Returns fn(onehot [C, K], contrib [R, K]) -> (pair_LL [C, C],
    marginal [C]) with C sharded over "model" and R over "data"; the sum
    over all ranks completes the pair reduction.  Every rank passes the
    same arrays and gets the same result."""

    def run(onehot, contrib):
        pair = _pair_from_ll(mesh, _local_ll(mesh, np.asarray(onehot),
                                             np.asarray(contrib)))
        return pair, pair_marginal(pair)

    return run


def sharded_align_step(mesh: Mesh, L: int, W: int,
                       full_outputs: bool = False,
                       scoring: dict = DEFAULT_SCORING):
    """Returns fn(reads [B, L], lens [B], refs [B, L+W]) sharded over
    "data" (replicated over "model"); B must be a multiple of the data-axis
    size.  full_outputs=True returns the complete NW forward tuple (scores,
    end_k, end_state, pointers) so the host backtrace can consume it; False
    returns scores only.  numpy arrays, the same on every rank."""
    n = mesh.shape["data"]

    def step(reads, lens, refs):
        assert reads.shape[1] == L and refs.shape[1] == L + W
        assert len(reads) % n == 0, (len(reads), n)
        lo, hi = _share(len(reads), mesh.data_index, n)
        out = banded_nw_forward_torch(
            np.ascontiguousarray(reads[lo:hi]),
            np.ascontiguousarray(lens[lo:hi]),
            np.ascontiguousarray(refs[lo:hi]), scoring, mesh.device)
        if not full_outputs:
            out = out[:1]
        got = tuple(mesh.all_gather(t, mesh.data_group).cpu().numpy()
                    for t in out)
        return got if full_outputs else got[0]

    return step


class ShardedNW:
    """Production device-sharded banded-NW forward: pads the batch to the
    data-axis size and runs the sharded step (SURVEY §2.3's data-parallel
    read mapping).  Drop-in for NWRunner.run.  `stats` counts the jobs of
    all ranks (every one ran on a rank's device) as the runner does."""

    def __init__(self, mesh: Mesh, L: int, W: int,
                 scoring: dict = DEFAULT_SCORING, stats=None):
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.L, self.W = L, W
        self.stats = stats
        self.step = sharded_align_step(mesh, L, W, full_outputs=True,
                                       scoring=scoring)

    def __call__(self, reads, lens, refs):
        B = reads.shape[0]
        Bp = -(-B // self.n_data) * self.n_data
        if Bp != B:
            pad = Bp - B
            reads = np.concatenate(
                [reads, np.full((pad, self.L), 4, dtype=reads.dtype)])
            lens = np.concatenate([lens, np.zeros(pad, dtype=lens.dtype)])
            refs = np.concatenate(
                [refs, np.full((pad, self.L + self.W), 4, dtype=refs.dtype)])
        s, ek, es, ptr = self.step(reads, lens, refs)
        if self.stats is not None:
            self.stats.bump(f"nw_jobs_on_{self.mesh.device.type}", B)
        return s[:B], ek[:B], es[:B], ptr[:B]


def full_step(mesh: Mesh, L: int, W: int):
    """The complete sharded step: banded-NW scoring of a read batch
    (data-parallel) + cluster-likelihood matmul + C^2 pair reduction
    (model x data).  fn(reads, lens, refs, onehot, contrib) -> (scores [B],
    pair [C, C])."""
    align = sharded_align_step(mesh, L, W)
    typing = sharded_typing_step(mesh)

    def step(reads, lens, refs, onehot, contrib):
        return align(reads, lens, refs), typing(onehot, contrib)[0]

    return step


def pair_ll_reduction_sharded(L: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Multi-device C^2 pair reduction: tiles of the matrix shard over
    "model", reads over "data"; each rank owns a range of K3's tile list of
    its read shard and the sum over all ranks completes it (the distributed
    replacement for the reference's OpenMP loop, HLATyper.cpp:2293-2364).

    Numerics as ops/pair_ll.pair_ll_reduction: the rank-1
    0.5*(rowsum+rowsum) term is added in f64; the device computes sum_r
    0.5*|a-b| + log1p(exp(-|a-b|)) in f32; zero-padded reads contribute
    log(2) each, cancelled by LOG_HALF per padded read over the SUM of the
    ranks' padded counts."""
    lo, hi = _share(L.shape[1], mesh.data_index, mesh.shape["data"])
    ll = to_device(np.ascontiguousarray(L[:, lo:hi], dtype=np.float32),
                   mesh.device)
    rowsum = torch.from_numpy(L[:, lo:hi].astype(np.float64).sum(axis=1))
    return _pair_from_ll(mesh, ll, rowsum)
