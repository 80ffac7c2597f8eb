"""The Transformer LM's SPMD pipeline over the stage axis — the port of
``distributed_model_parallel_tpu/parallel/spmd_pipeline.py``
(``make_pipeline_apply``, ``make_1f1b_loss_and_grad``, the interleave
permutation, ``make_spmd_eval_loss``).

The JAX pipeline is one ``shard_map`` program: every device runs its
stage's rows of the stacked ``blocks`` on every tick, masks the bubbles,
and the activations hop one stage a tick by ``ppermute``. Here each rank
of a stage ring (``mesh.MeshSpec.stage_group``: the ranks of one ``(data,
model, seq, expert)`` coordinate) is a process that runs **only its own
operations** on the static tick table the SPMD CNN engine runs
(``parallel/schedule.spmd_ticks`` with ``head="last"``), the same on
every rank: at each tick a stage runs at most one chunk forward (``F``)
or backward (``B``), then every hop made at that tick — a chunk's output
``[mbs, T_local, d]`` forward, a chunk input's cotangent back — is posted
in one ``batch_isend_irecv`` (``ops/collectives.exchange``, counted
under ``pp``). Bubbles are idle, not garbage compute.

* Stage 0 embeds (learned positions at the seq shard's offset); the last
  chunk's stage runs ``ln_f``, the head and the NLL **sum** of its tokens
  (dense or chunked) inside that chunk, so nothing of the head hops.
* ``"gpipe"``: every forward keeps its autograd graph, then every
  backward runs (all M microbatches' activations live at the peak).
* ``"1f1b"``: JAX's order. A forward runs without a graph and stashes its
  chunk input; the backward recomputes the chunk from the stash (stage 0
  recomputes the embedding) and pulls the cotangent through it. A stage
  holds at most ``K = min(2D - 1, M·V + D - 1)`` stashed inputs
  (``schedule.stash_slots``).
* Interleaved (``V = virtual_stages > 1``, 1f1b only): chunk ``c = v·S +
  s`` of ``D = V·S`` equal chunks runs on stage ``s``; the blocks are kept
  in JAX's storage order (:func:`interleave_block_rows`), so a stage's
  rows ``[v·Lc, (v+1)·Lc)`` are its chunk ``v``.

Every chunk execution's stats vector (the mean over its layers) enters
the rank's loss as ``aux_loss`` of the mean over the chunk executions of
its microbatches — JAX's mean over layers, stages and real microbatches —
so each chunk's backward carries the weighted stats' cotangent (zero for
the drop rate; a dense model carries nothing). The gradient is that of
the rank's loss: the NLL summed over its microbatches over its token
count, plus that term; ``spmd_lm.reduce_grads`` completes it over the
mesh. The loss and stats of a step are summed over the stage ring.
"""

from __future__ import annotations

import torch

from distributed_model_parallel_tpu_torch.models import transformer as tfm
from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_reduce_,
    exchange,
)
from distributed_model_parallel_tpu_torch.parallel.schedule import (
    _makes,
    _needs,
    spmd_ticks,
)


def check_pipeline_config(cfg, num_stages: int, num_microbatches: int,
                          schedule: str, virtual_stages: int) -> None:
    """Raise JAX's errors, in its words, for a schedule it refuses: an
    unknown schedule, virtual stages under gpipe, and under interleaving
    microbatches not divisible by the stages or layers not divisible into
    ``V·S`` chunks. A layer count the stages do not split raises too
    (JAX's stage sharding cannot place it)."""
    S, M, V = num_stages, num_microbatches, virtual_stages
    if schedule == "1f1b":
        if V < 1:
            raise ValueError(f"virtual_stages must be >= 1, got {V}")
        if V > 1:
            if M % S:
                raise ValueError(
                    f"interleaved schedule needs num_microbatches divisible "
                    f"by the stage count: M={M}, S={S} (Megatron constraint "
                    f"— the microbatch groups cycle chunks in blocks of S)")
            if cfg.n_layers % (V * S):
                raise ValueError(
                    f"n_layers={cfg.n_layers} must divide into D=V*S="
                    f"{V * S} equal chunks for interleaved placement")
    elif schedule == "gpipe":
        if V != 1:
            raise ValueError(
                "interleaved virtual stages are a 1f1b schedule feature "
                "(gpipe's whole-program AD would gain nothing — no "
                "silent ignores)")
    else:
        raise ValueError(f"unknown spmd pipeline schedule {schedule!r}; "
                         f"known: gpipe, 1f1b")
    if M < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {M}")
    if cfg.n_layers % S:
        raise ValueError(f"n_layers={cfg.n_layers} does not split over "
                         f"{S} stages")


def interleave_perm(n_layers: int, S: int, V: int) -> list[int]:
    """JAX's canonical → storage layer permutation (``_interleave_perm``):
    storage row ``s·(V·Lc) + v·Lc + j`` holds canonical layer ``(v·S +
    s)·Lc + j``, so stage s's contiguous rows are its V chunks back to
    back."""
    lc = n_layers // (S * V)
    return [(v * S + s) * lc + j for s in range(S) for v in range(V)
            for j in range(lc)]


def interleave_block_rows(blocks: dict, n_layers: int, S: int,
                          V: int) -> dict:
    """Every stacked ``blocks`` leaf's layer dim from canonical into the
    interleaved storage order (V=1: the leaves as they are)."""
    if V == 1:
        return blocks
    perm = torch.tensor(interleave_perm(n_layers, S, V))
    return {k: w.index_select(0, perm.to(w.device)) for k, w in
            blocks.items()}


def deinterleave_block_rows(blocks: dict, n_layers: int, S: int,
                            V: int) -> dict:
    """The inverse of :func:`interleave_block_rows` (export, eval
    elsewhere, the tests)."""
    if V == 1:
        return blocks
    inv = torch.argsort(torch.tensor(interleave_perm(n_layers, S, V)))
    return {k: w.index_select(0, inv.to(w.device)) for k, w in
            blocks.items()}


class LMPipeline:
    """This rank's stage of the LM pipeline: the tick tables of its
    schedule and its chunks. ``run`` drives one step (or one evaluation)
    over this rank's ``[b, T_local]`` shard of the batch."""

    def __init__(self, cfg, spec, num_microbatches: int = 1,
                 schedule: str = "gpipe", virtual_stages: int = 1):
        S = spec.num_stages
        check_pipeline_config(cfg, S, num_microbatches, schedule,
                              virtual_stages)
        self.cfg, self.spec = cfg, spec
        self.S, self.s = S, spec.stage_index
        self.M, self.V = num_microbatches, virtual_stages
        self.D = S * virtual_stages
        self.schedule = schedule
        self.lc = cfg.n_layers // self.D
        self.train_ticks = spmd_ticks(S, self.M, schedule,
                                      virtual_stages=self.V, head="last")
        self.eval_ticks = spmd_ticks(S, self.M, schedule, train=False,
                                     virtual_stages=self.V, head="last")
        if spec.stage_group is not None:
            # The ring's communicator is made by a call every rank joins
            # (NCCL's first point-to-point batch must hold every rank).
            all_reduce_(torch.zeros((), device=spec.device),
                        spec.stage_group, kind="barrier")
        w = [cfg.moe_aux_weight, cfg.moe_z_weight, 0.0]
        self._aux_cot = (torch.tensor(w, dtype=torch.float32,
                                      device=spec.device)
                         / (self.M * self.D) if cfg.moe_experts else None)

    def bubble_share(self, train: bool = True) -> float:
        """The share of idle (stage, tick) slots of the table — the bubble
        the schedule implies, every operation counted as one slot."""
        ticks = self.train_ticks if train else self.eval_ticks
        idle = sum(op is None for row in ticks for op in row)
        return idle / (len(ticks) * self.S)

    def _chunk(self, blocks: dict, c: int) -> dict:
        """Chunk c's rows of this stage's stack (views: their gradients
        land in the stacked leaves)."""
        lo = (c // self.S) * self.lc
        return {k: w[lo:lo + self.lc] for k, w in blocks.items()}

    def _nll_sum(self, params: dict, y: torch.Tensor,
                 tgt: torch.Tensor) -> torch.Tensor:
        """The NLL sum over ``y``'s tokens through the dense or chunked
        head (f32)."""
        cfg = self.cfg
        if cfg.loss_chunk:
            n_seq = self.spec.num_seq if cfg.sp_axis else 1
            chunk = tfm.local_loss_chunk(cfg, y.shape[1], n_seq)
            return tfm.chunked_nll_sum(params, y, tgt, chunk)
        logp = torch.log_softmax(tfm.unembed(params, y).float(), dim=-1)
        return -torch.gather(logp, -1, tgt[..., None])[..., 0].sum()

    def _objective(self, aux: torch.Tensor) -> torch.Tensor | None:
        """A chunk execution's share of the rank's MoE loss terms."""
        if self._aux_cot is None:
            return None
        return (aux * self._aux_cot).sum()

    def run(self, params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            *, train: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """One pass of the table over this rank's shard (``[b, T_local]``
        tokens and targets): the forwards (and, under ``train``, the
        backwards, accumulating the gradients of the rank's loss into
        the parameters' ``.grad``). Returns ``(nll, aux)`` summed over the
        stage ring: the NLL sum of the shard's tokens (f32) and the sum of
        the chunk executions' stats vectors."""
        cfg, spec, S, D, M, s = (self.cfg, self.spec, self.S, self.D,
                                 self.M, self.s)
        b, t = tokens.shape
        if b % M:
            raise ValueError(f"local batch {b} not divisible by M={M}")
        mbs = b // M
        n_local = b * t
        toks = tokens.reshape(M, mbs, t)
        tgts = targets.reshape(M, mbs, t)
        dev = spec.device
        ticks = self.train_ticks if train else self.eval_ticks
        recompute = train and self.schedule == "1f1b"
        blocks = params["blocks"]
        nll = torch.zeros((), dtype=torch.float32, device=dev)
        aux_sum = torch.zeros(tfm.AUX_STATS, dtype=torch.float32, device=dev)
        inbox: dict = {}
        held: dict = {}
        for row in ticks:
            sends = []
            op = row[s]
            if op is not None:
                kind, m, c = op
                need = _needs(op, D, "last")
                got = inbox.pop(need) if need is not None else None
                if kind == "F":
                    out, nll_m, aux = self._forward(
                        params, blocks, toks[m], tgts[m], c, got, train,
                        recompute, held, m)
                    aux_sum += aux
                    if nll_m is not None:
                        nll += nll_m
                else:
                    out, nll_m = self._backward(
                        params, blocks, toks[m], tgts[m], c, got, held, m,
                        n_local, recompute)
                    if nll_m is not None:
                        nll += nll_m
                made = _makes(op, S, D, train, "last")
                if made is not None:
                    key, dst = made
                    if dst == s:
                        inbox[key] = out
                    else:
                        sends.append((out, spec.stage_rank(dst)))
            recvs, keys = [], []
            for s2, op2 in enumerate(row):
                if op2 is None or s2 == s:
                    continue
                made = _makes(op2, S, D, train, "last")
                if made is not None and made[1] == s:
                    recvs.append((torch.empty(
                        (mbs, t, cfg.d_model), dtype=cfg.dtype, device=dev),
                        spec.stage_rank(s2)))
                    keys.append(made[0])
            if sends or recvs:
                exchange(sends, recvs, spec.stage_group, kind="pp")
                for key, (buf, _) in zip(keys, recvs):
                    inbox[key] = buf
        if S > 1:
            both = torch.cat([nll[None], aux_sum])
            all_reduce_(both, spec.stage_group, kind="pp_loss")
            nll, aux_sum = both[0], both[1:]
        return nll, aux_sum

    def _embed(self, params: dict, tok: torch.Tensor) -> torch.Tensor:
        return tfm.embed_local(params, tok, self.cfg, self.spec).to(
            self.cfg.dtype)

    def _forward(self, params, blocks, tok, tgt, c, got, train, recompute,
                 held, m):
        """Chunk c's forward of microbatch m: ``(output to send, the NLL
        sum where the chunk is the last and its loss is taken now, the
        chunk's stats)``. gpipe keeps the graph in ``held``; 1f1b stashes
        the chunk input there and keeps no graph."""
        cfg, last = self.cfg, c == self.D - 1
        if not train or recompute:
            with torch.no_grad():
                x = self._embed(params, tok) if c == 0 else got
                y, aux = tfm.blocks_scan(self._chunk(blocks, c), x, cfg,
                                         self.spec)
                nll = (self._nll_sum(params, y, tgt)
                       if last and not train else None)
            if recompute:
                held[m, c] = None if c == 0 else x
            return (None if last else y), nll, aux.float()
        x = (self._embed(params, tok) if c == 0
             else got.detach().requires_grad_(True))
        y, aux = tfm.blocks_scan(self._chunk(blocks, c), x, cfg, self.spec)
        nll = self._nll_sum(params, y, tgt) if last else None
        held[m, c] = (x, y, aux, nll)
        return (None if last else y.detach()), None, aux.detach().float()

    def _backward(self, params, blocks, tok, tgt, c, got, held, m, n_local,
                  recompute):
        """Chunk c's backward of microbatch m: ``(the cotangent of its
        input, to send; the NLL sum where the chunk is the last)``. 1f1b
        first recomputes the chunk from its stashed input."""
        cfg, last = self.cfg, c == self.D - 1
        if recompute:
            x_in = held.pop((m, c))
            x = (self._embed(params, tok) if c == 0
                 else x_in.requires_grad_(True))
            y, aux = tfm.blocks_scan(self._chunk(blocks, c), x, cfg,
                                     self.spec)
            nll = self._nll_sum(params, y, tgt) if last else None
        else:
            x, y, aux, nll = held.pop((m, c))
        extra = self._objective(aux)
        if last:
            obj = nll / n_local
            torch.autograd.backward(obj if extra is None else obj + extra)
        elif extra is None:
            torch.autograd.backward(y, got)
        else:
            torch.autograd.backward([y, extra], [got, None])
        out = x.grad if c > 0 else None
        return out, (nll.detach() if last else None)
