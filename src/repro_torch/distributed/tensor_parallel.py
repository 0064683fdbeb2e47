"""Tensor-parallel compute over a mesh's ``model`` axis, for the sharded
train, prefill and decode steps of every LM family.

JAX pjits its steps onto ``sharding.py``'s specs, and XLA's partitioner
splits the compute where a spec names ``model``.  The port has no
partitioner, so this module does that work by hand, in Megatron's form:
:class:`TensorParallel` is the context that ``launch/steps.py`` hands to
``models/transformer.py`` and ``models/layers.py`` (``tp=``; ``None`` on
the unsharded path).  The three kinds of step share the splits below;
the serve steps add where the KV cache lies (:attr:`TensorParallel.cache`).

Routes, by ``cfg.family`` (:func:`for_step`):

* ``"dense"`` (olmo-1b, stablelm-1.6b, gemma2-2b, internlm2-20b),
  ``"vlm"`` (paligemma-3b's text decoder and ``vision_proj``),
  ``"moe"`` (granite-moe-3b-a800m, moonshot-v1-16b-a3b: the attention,
  embedding and head as the dense families', the MoE block below),
  ``"ssm"`` (mamba2-1.3b: the Mamba-2 mixer below, no attention) and
  ``"hybrid"`` (hymba-1.5b: the attention as the dense families', the
  Mamba-2 mixer beside it, the GLU MLP) and ``"audio"`` (whisper-base:
  the encoder's and decoder's self-attention and the decoder's
  cross-attention split as the dense families' attention, with
  biases, and the plain MLP) take the tensor-parallel route below;
* a mesh without a ``model`` axis takes the FSDP route: every param
  gathered whole, the whole loss on every rank.

On the tensor-parallel route each param is gathered over the batch's
mesh dims only and keeps the ``model`` split of :meth:`placements`:

* column-parallel linears (``attn/w[qkv]``, ``mlp/w[ig]``, ``lm_head``,
  ``vision_proj``) hold a slice of the outputs, and of their bias; their
  input passes :meth:`~TensorParallel.copy_in` (identity forward,
  all-reduce backward) once for all the linears that read it (whisper's
  cross-attention reads the encoder states, which pass it once for
  every decoder layer);
* row-parallel linears (``attn/wo``, ``mlp/wo``) hold a slice of the
  contraction; their partial products pass
  :meth:`~TensorParallel.reduce_out` (all-reduce forward, identity
  backward), and a bias is added once,
  after it (``layers.linear(tp=)``).  Fake-quant's absmax over the split
  contraction is the max over ``model`` (:meth:`fake_quant_rows`);
* attention splits the query heads where ``n_heads`` divides ``model``,
  and the KV heads with them where ``n_kv`` does; where it does not,
  ``wk``/``wv`` are gathered whole and each rank takes the KV heads its
  query heads read (:meth:`attn_shard`).  Where ``n_heads`` does not
  divide ``model``, the layer's attention runs whole heads on every
  rank, as the FSDP route does;
* the embedding is split on the vocab: each rank looks up the tokens of
  its range and ``reduce_out`` sums the rows (:meth:`embed`); the
  logits stay split and :meth:`cross_entropy` reduces the max, the sum
  of exponentials and the target's logit over ``model``;
* the MoE block (``models/moe.py``, ``tp=``) splits each stacked expert
  on ``d_ff_expert`` (``mlp/w[ig]`` ``(E, d, f)`` on ``f``, ``mlp/wo``
  ``(E, f, d)`` on ``f``: Megatron's MLP split once an expert) and the
  shared experts as a dense MLP; the router stays replicated and runs on
  the replicated input, so every rank routes the same; one
  ``reduce_out`` a layer sums the gate-combined partial outputs, the
  shared experts' included.  The expert ``wo``'s fake-quant groups run
  along the split ``f``: :meth:`fake_quant_rows`' rule;
* the Mamba-2 mixer (``models/mamba2.py``, ``tp=``) splits its heads
  where ``nh`` divides ``model`` (and B and C form one group, which
  every head reads): the rank runs heads ``[r nh / m, (r + 1) nh / m)``,
  which ``din``'s head-major layout aligns with JAX's splits of
  ``A_log``, ``dt_bias``, ``D``, ``norm_g`` and ``out_proj``'s rows.
  ``in_proj`` (z, x, B, C and dt side by side, its columns stored
  contiguously split) and the conv (channels x, B, C) are gathered
  whole and narrowed to what the rank's heads read: their z, x and dt,
  B and C whole (:meth:`ssm_shard`), as ``wk``/``wv`` are for gathered
  KV heads.  The input passes ``copy_in``; the conv and the SSD scan run
  on the rank's channels with no collective; the gated norm's mean over
  the whole ``din`` is summed over ``model`` (:meth:`sum_over`);
  ``out_proj`` is row-parallel, one ``reduce_out`` a layer.  In the
  hybrid, the attention and the mixer, both split, read one ``copy_in``
  of their input (``transformer._block_full``), and it mixes their
  outputs, both reduced, as the unsharded layer does.

A part whose dim does not divide ``model`` (``d_ff``, ``d_ff_expert``,
the vocab, ``d_model`` for ``vision_proj``, the SSM heads) runs whole on
every rank.  Every ``model`` rank of a data group sees the same rows, so
a gradient is summed over the batch's mesh dims only: a split param's
gradient is its own slice, a param run whole has the same gradient on
every ``model`` rank, and ``wk``/``wv`` gathered for their KV heads and
``in_proj`` and the conv gathered for the SSM heads have partial sums
(:meth:`placements`).

The prefill and decode steps run the same splits forward only, and the
KV cache stays where ``sharding.cache_entry_spec`` puts ``model``
(:attr:`TensorParallel.cache`):

* ``"heads"`` (the KV heads split: olmo-1b, stablelm-1.6b on 16): the
  rank computes, writes and attends over its own KV heads;
* ``"seq"`` (the sequence split: internlm2-20b, gemma2-2b, paligemma-3b
  on 16): a prefill keeps every KV head of the rank's positions
  (computed from ``wk``/``wv`` whole); a decode step writes the new
  position on the rank that holds it and attends over the rank's
  positions with every query head (gathered where split,
  :meth:`gather_heads`), the softmax's max, sum and ``p @ v`` reduced
  over ``model`` (:meth:`softmax`, :meth:`all_reduce`): the merge
  ``kv_attention.cu`` does across a thread-block cluster, across ranks;
* ``"whole"`` (neither divides ``model``): every rank holds and writes
  the whole cache and attends with its query heads over the KV heads
  they read (:meth:`kv_view`).

Whisper's cross-attention cache (``xk``/``xv``, the encoder states'
K/V, ``T_enc`` positions) takes the same rule on its own shape
(:attr:`TensorParallel.xcache`): a prefill emits the rank's share, a
decode step attends over it (on ``"seq"`` with the softmax merged over
``model``) and never writes it.  Its route can differ from the self
cache's: the card's 1500 frames do not divide 16 where a prompt padded
to a multiple of 16 does.

A Mamba-2 layer's state ``ssm`` ``(L, B, nh, hp, N)`` is the rank's
heads' where they split (its spec splits ``nh``), else whole; its conv
inputs ``conv`` ``(L, B, W - 1, conv_ch)`` are whole on every rank (the
rank's x channels gathered over ``model``), since their spec's
contiguous channel split is not the rank's heads'.  The serve steps
place both as the spec says (``launch/steps.py``).

The collectives are ``torch.distributed``'s functional ones
(``_c10d_functional``), which the dry run's walker counts.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.quant.qat import _ClipRoundSTE, fake_quant

#: the model-axis layout of each split param: (path regex, part, dim).
#: The ``attn/`` rows match whisper's cross-attention leaves
#: (``xattn/w[qkv]/[wb]``, ``xattn/wo/w``) too, on purpose: JAX's rules
#: split ``xattn/`` as ``attn/``, and both run through one ``_mha``
_SPLITS = [
    (r"^embed$", "vocab", 0),
    (r"^lm_head/w$", "vocab", 1),
    (r"^vision_proj/w$", "vision", 1),
    (r"attn/wq/w$", "heads", 1),
    (r"attn/wq/b$", "heads", 0),
    (r"attn/w[kv]/w$", "kv", 1),
    (r"attn/w[kv]/b$", "kv", 0),
    (r"attn/wo/w$", "heads", 0),
    (r"mlp/w[ig]/w$", "mlp", 1),
    (r"mlp/wo/w$", "mlp", 0),
    (r"mlp/w[ig]$", "experts", 2),           # stacked (E, d, f)
    (r"mlp/wo$", "experts", 1),              # stacked (E, f, d)
    (r"mlp/shared_w[ig]$", "shared", 1),
    (r"mlp/shared_wo$", "shared", 0),
    # the Mamba-2 mixer: dim None marks a param held whole and narrowed
    # to the rank's channels (``TensorParallel.ssm_shard``)
    (r"ssm/in_proj/w$", "ssm", None),
    (r"ssm/conv_[wb]$", "ssm", None),
    (r"ssm/out_proj/w$", "ssm", 0),
    (r"ssm/(A_log|dt_bias|D|norm_g)$", "ssm", 0),
]


def _wait(t: torch.Tensor) -> torch.Tensor:
    return torch.ops._c10d_functional.wait_tensor(t)


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    return _wait(torch.ops._c10d_functional.all_reduce(
        t.contiguous(), op, group.group_name))


class _CopyIn(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    """All-reduce forward and backward: a sum over a group whose every
    rank's loss depends on the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group), None


def mean_over(mesh, dims):
    """``t -> `` the mean of ``t`` over the ranks of ``mesh``'s dims
    ``dims`` (those a batch is split on, evenly): ``t`` is the mean over
    the rank's rows, the result the mean over the global batch.  Its
    gradient sums every rank's, as each rank's loss holds the mean.
    ``None`` where the dims hold one rank."""
    groups = [mesh.get_group(i) for i in dims if mesh.size(i) > 1]
    if not groups:
        return None
    n = 1
    for i in dims:
        n *= mesh.size(i)

    def mean(t):
        for g in groups:
            t = _SumOver.apply(t, g)
        return t / n

    return mean


class _GatherLast(torch.autograd.Function):
    """All-gather along the last dim forward; the rank's slice of the
    gradient backward (every rank holds the same gradient of the
    gathered tensor)."""

    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.rank, ctx.n = rank, x.shape[-1]
        moved = x.movedim(-1, 0).contiguous()
        whole = _wait(torch.ops._c10d_functional.all_gather_into_tensor(
            moved, size, group.group_name))
        return whole.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.n
        return g[..., lo:lo + ctx.n], None, None, None


class _VocabLogSumExp(torch.autograd.Function):
    """``logsumexp`` over a vocab split across ``model``, in
    ``torch.logsumexp``'s arithmetic: ``log(sum(exp(x - max))) + max``,
    the max and the sum reduced over the group; backward
    ``g * exp(x - lse)`` on the rank's slice (every rank holds the same
    ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        m = _all_reduce(torch.amax(x, dim=-1, keepdim=True), "max", group)
        s = _all_reduce(torch.sum(torch.exp(x - m), dim=-1), "sum", group)
        lse = torch.log(s) + m[..., 0]
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(x - lse[..., None]), None


class TensorParallel:
    """The ``model`` axis of ``mesh`` and how ``cfg``'s layers split over
    it.  Flags: ``heads`` (query heads split), ``kv`` (KV heads split
    with them), ``mlp`` (a dense FFN's ``d_ff`` split), ``experts`` (the
    stacked experts' ``d_ff_expert`` split), ``shared`` (the shared
    experts' ``d_ff_expert * n_shared_experts`` split), ``vocab``,
    ``vision`` (``vision_proj``'s outputs split).  :meth:`on` gives the
    context for a part that splits, else ``None``.  ``cache``: where a
    serve step's KV cache splits over ``model`` (``"heads"``, ``"seq"``
    or ``"whole"``; module docstring), which the step sets; ``None`` in
    the train step.  ``xcache``: the same for whisper's cross-attention
    cache ``xk``/``xv``.  ``ssm``: the Mamba-2 mixer's heads split
    (module docstring); ``ssm_heads`` the rank's count of them."""

    def __init__(self, cfg, mesh):
        self.group = mesh.get_group("model")
        self.size = mesh.size(mesh.mesh_dim_names.index("model"))
        self.rank = mesh.get_local_rank("model")
        m = self.size
        # an attention-free config (mamba2) has n_heads 0, which divides
        self.heads = cfg.n_heads > 0 and cfg.n_heads % m == 0
        self.kv = self.heads and cfg.n_kv % m == 0
        moe = cfg.moe
        self.mlp = moe is None and cfg.d_ff > 0 and cfg.d_ff % m == 0
        self.experts = moe is not None and moe.d_ff_expert % m == 0
        self.shared = moe is not None and moe.n_shared_experts > 0 and \
            moe.d_ff_expert * moe.n_shared_experts % m == 0
        self.vocab = cfg.vocab % m == 0
        self.vision = bool(cfg.vision_prefix_len) and cfg.d_model % m == 0
        self.head_dim = cfg.head_dim
        self.n_heads = cfg.n_heads // m if self.heads else cfg.n_heads
        self.n_kv, self._kv_cols, self._kv_index = cfg.n_kv, None, None
        self.cache: Optional[str] = None
        self.xcache: Optional[str] = None
        if self.kv:
            self.n_kv = cfg.n_kv // m
        elif self.heads:
            self._plan_kv_gather(cfg)
        s = cfg.ssm if cfg.family == "ssm" or cfg.hybrid_parallel_ssm \
            else None
        # with one group of B and C, which every head reads
        self.ssm = s is not None and s.n_groups == 1 and \
            s.n_heads(cfg.d_model) % m == 0
        self._index = {}
        if self.ssm:
            self._plan_ssm(s, cfg.d_model)

    def _plan_kv_gather(self, cfg) -> None:
        """The KV heads this rank's query heads read, from ``wk``/``wv``
        gathered whole: their column range, and, where the local query
        heads do not fall into equal groups of consecutive heads, the KV
        head of each query head."""
        g = cfg.n_heads // cfg.n_kv
        first = self.rank * self.n_heads
        kv_of = [(first + i) // g for i in range(self.n_heads)]
        lo, hi = kv_of[0], kv_of[-1] + 1
        self.n_kv = hi - lo
        self._kv_cols = (lo * self.head_dim, hi * self.head_dim)
        per = self.n_heads // self.n_kv
        if self.n_heads % self.n_kv or any(
                k - lo != i // per for i, k in enumerate(kv_of)):
            self._kv_index = torch.tensor([k - lo for k in kv_of])

    def _plan_ssm(self, s, d_model: int) -> None:
        """The rank's SSM heads ``[r * nh / m, (r + 1) * nh / m)`` and the
        conv channels and ``in_proj`` columns they read: the x channels
        of those heads and B and C whole (``_ssm_conv``), and z, those
        channels and the heads' dt (``_ssm_cols``), in ``in_proj``'s
        order."""
        din, hp = s.d_inner(d_model), s.head_dim
        gn = s.n_groups * s.d_state
        self.ssm_heads = s.n_heads(d_model) // self.size
        h0 = self.rank * self.ssm_heads
        x = torch.arange(h0 * hp, (h0 + self.ssm_heads) * hp)
        self._ssm_conv = torch.cat([x, torch.arange(din, din + 2 * gn)])
        dt = 2 * din + 2 * gn + h0
        self._ssm_cols = torch.cat([x, din + self._ssm_conv,
                                    torch.arange(dt, dt + self.ssm_heads)])

    def _on_device(self, name: str, device) -> torch.Tensor:
        """Index tensor ``name`` on ``device``, copied there once."""
        key = (name, device)
        if key not in self._index:
            self._index[key] = getattr(self, name).to(device)
        return self._index[key]

    def on(self, part: str) -> Optional["TensorParallel"]:
        return self if getattr(self, part) else None

    # --- placements ---------------------------------------------------------

    def placements(self, path) -> tuple:
        """(forward, gradient) placement on the ``model`` mesh dim of the
        param at ``path``: ``Shard(d)`` for a split param, ``Replicate()``
        for one run whole, and for ``wk``/``wv`` gathered for their KV
        heads ``Replicate()`` and ``Partial()``."""
        ps = "/".join(str(k) for k in path)
        for pat, part, dim in _SPLITS:
            if re.search(pat, ps):
                if getattr(self, part) and dim is None:
                    return Replicate(), Partial()
                if getattr(self, part):
                    return Shard(dim), Shard(dim)
                if part == "kv" and self.heads:
                    return Replicate(), Partial()
                break
        return Replicate(), Replicate()

    # --- collectives --------------------------------------------------------

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.group)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self.group)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherLast.apply(x, self.group, self.size, self.rank)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return _all_reduce(x, op, self.group)

    def sum_over(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over ``model`` that every rank's outputs depend on:
        all-reduced forward and backward (:class:`_SumOver`)."""
        return _SumOver.apply(x, self.group)

    def gather_heads(self, q: torch.Tensor) -> torch.Tensor:
        """``(B, S, n_heads / model, hd)`` -> every rank's heads, in
        order."""
        b, s, h, hd = q.shape
        return self.gather_last(q.reshape(b, s, h * hd)).reshape(
            b, s, h * self.size, hd)

    def softmax(self, s: torch.Tensor) -> torch.Tensor:
        """``torch.softmax`` over the last dim of scores split over
        ``model``: ``exp(s - max) / sum``, the max and the sum reduced
        over the group."""
        m = self.all_reduce(torch.amax(s, dim=-1, keepdim=True), "max")
        e = torch.exp(s - m)
        return e / self.all_reduce(torch.sum(e, dim=-1, keepdim=True))

    def seq_range(self, n: int) -> tuple:
        """This rank's positions ``[lo, hi)`` of a length-``n`` sequence
        split over ``model``."""
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    # --- layers -------------------------------------------------------------

    def attn_shard(self, lp):
        """The attention params this rank computes with: ``lp`` itself
        where the KV heads split, else ``wk``/``wv`` narrowed to the
        columns of the KV heads this rank reads."""
        if self._kv_cols is None:
            return lp
        lo, hi = self._kv_cols

        def cols(p):
            out = {"w": p["w"][:, lo:hi]}
            if "b" in p:
                out["b"] = p["b"][lo:hi]
            return out

        return {**lp, "wk": cols(lp["wk"]), "wv": cols(lp["wv"])}

    def expand_kv(self, t: torch.Tensor) -> torch.Tensor:
        """``(B, S, n_kv, hd)`` -> one KV head per local query head, where
        the query heads do not group evenly over the KV heads read."""
        if self._kv_index is None:
            return t
        return t[:, :, self._kv_index.to(t.device)]

    def kv_view(self, t: torch.Tensor) -> torch.Tensor:
        """A cache ``(B, S, n_kv, ...)`` holding every KV head -> the KV
        heads this rank's query heads read (:meth:`expand_kv`'s
        layout)."""
        if self._kv_cols is None:
            return t
        lo, hi = (c // self.head_dim for c in self._kv_cols)
        return self.expand_kv(t[:, :, lo:hi])

    def ssm_shard(self, p):
        """The Mamba-2 params this rank computes with: ``in_proj``'s
        columns and the conv's channels narrowed to what its heads read
        (:meth:`_plan_ssm`), ``in_proj`` laid out as the whole one with
        the local ``d_inner`` and heads; the other leaves are the rank's
        shards already.  A narrowed leaf's gradient is zero where the
        rank's heads do not read it and partial on B and C
        (:meth:`placements`: ``Partial()``)."""
        cols = self._on_device("_ssm_cols", p["conv_w"].device)
        ch = self._on_device("_ssm_conv", p["conv_w"].device)
        return {**p, "in_proj": {"w": p["in_proj"]["w"].index_select(1, cols)},
                "conv_w": p["conv_w"].index_select(1, ch),
                "conv_b": p["conv_b"].index_select(0, ch)}

    def ssm_channels(self, t: torch.Tensor) -> torch.Tensor:
        """Conv inputs ``(..., conv_ch)`` of every channel -> the rank's
        (:meth:`ssm_shard`'s conv layout)."""
        return t.index_select(-1, self._on_device("_ssm_conv", t.device))

    def fake_quant_rows(self, w: torch.Tensor, pc) -> torch.Tensor:
        """``fake_quant(W^T)^T`` (the last two dims swapped) of a
        row-parallel ``W`` ``(..., d_in, d_out)`` with ``d_in`` split
        (a linear's ``wo``, or the stacked experts' ``(E, f, d)``):
        the group rule is decided on the whole ``d_in``; a per-channel
        absmax is the max over ``model``; groups that straddle shards
        are quantized on the gathered contraction."""
        wt = w.transpose(-1, -2)
        n_loc = wt.shape[-1]
        n = n_loc * self.size
        gs = n if pc.group_size == -1 else pc.group_size
        if n % gs:
            gs = n
        if gs < n and n_loc % gs == 0:
            return fake_quant(wt, pc).transpose(-1, -2)
        if gs < n:
            lo = self.rank * n_loc
            return fake_quant(self.gather_last(wt), pc)[
                ..., lo:lo + n_loc].transpose(-1, -2)
        absmax = _all_reduce(torch.amax(torch.abs(wt), dim=-1, keepdim=True)
                             .detach(), "max", self.group)
        scale = torch.clamp_min(absmax / pc.qmax, 1e-8)
        q = _ClipRoundSTE.apply(wt / scale, pc.qmin, pc.qmax)
        return (q * scale).transpose(-1, -2)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """Rows of a vocab-split ``table``: each rank's rows for the
        tokens in its range, zeros elsewhere, summed over ``model``."""
        n = table.shape[0]
        local = tokens - self.rank * n
        ok = (local >= 0) & (local < n)
        rows = table[torch.where(ok, local, 0)]
        rows = torch.where(ok[..., None], rows, torch.zeros_like(rows))
        return self.reduce_out(rows)

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor):
        """(summed cross-entropy, count of unmasked labels) of
        vocab-split float32 ``logits`` ``(B, S, vocab / model)``: the
        max, the sum of exponentials (:class:`_VocabLogSumExp`) and the
        target's logit reduced over ``model``.  On a one-rank ``model``
        axis this is ``_chunk_loss``'s arithmetic, bit for bit."""
        n = logits.shape[-1]
        mask = (labels >= 0).to(torch.float32)
        lse = _VocabLogSumExp.apply(logits, self.group)
        local = torch.clamp(labels, min=0).to(torch.int64) - self.rank * n
        ok = (local >= 0) & (local < n)
        tgt = torch.gather(logits, -1, torch.where(ok, local, 0)[..., None])
        tgt = self.reduce_out(torch.where(ok, tgt[..., 0],
                                          torch.zeros_like(lse)))
        return torch.sum((lse - tgt) * mask), torch.sum(mask)


def for_step(cfg, mesh) -> Optional[TensorParallel]:
    """A step's context on ``mesh``, or ``None`` for the FSDP route (a
    mesh without a ``model`` axis)."""
    if "model" not in (mesh.mesh_dim_names or ()):
        return None
    return TensorParallel(cfg, mesh)
