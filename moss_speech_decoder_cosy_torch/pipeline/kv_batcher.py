"""Continuous-batching KV flow decoding (a pool of lanes serving concurrent
streams), after the JAX package's ``pipeline/kv_batcher.py``
(``KVContinuousBatcher``).

A fixed pool of LANES shares one batched estimator wavefront.  A stream is
admitted into a free lane at any time (its prompt prefilled, its cache rows
scattered into the pool), advances only while it has encoded chunks, stalls
otherwise, drains when finished, and frees its lane.  N live streams cost
one wavefront forward per tick whatever their positions:

- the estimator's attention has no positional term and each flat row
  (ODE step s, CFG half, lane) attends only within its own ring, so lanes
  at different stream positions batch into one forward; each row writes
  its chunk K/V at its own position (``kv_stream.wave_lanes_step``; the
  kernel engine runs ``fused_tf_group`` in its per-row write mode,
  ``wave_lanes_step_kernel``), and stalled or invalid rows keep their
  rings;
- the encoder is position-dependent (rel-pos tables), so it runs per lane,
  one hop per chunk, into a per-lane buffer of mu chunks that the wavefront
  reads by index.

With ``fused=False`` the lanes run the concat dataflow (JAX
``CausalConditionalCFMWaveLanes`` with ``fused=False``): attention over
[ring ++ chunk], each row's chunk written after the estimator, over rings at
their canonical capacity, on the unfused engine.  ``ring_quant=True`` (concat
lanes only) keeps the lane rings as int8 values with per-frame f32 scales,
each row's chunk quantized and written through ``write_ring_leaf``.

State lives on the device in pools made once: the est rings (``(ring +
hop) * ratio`` slots for the fused dataflow, ``ring * ratio`` for the
concat one, canonical numbering frame f -> slot f % rp) in the kernel's
grouped layout, the x / mu waves, the mu chunks,
each lane's ``w``, speaker vector and base frame, the token buffer, the
per-lane encoder caches and token counts, and the per-lane vocoder caches.
A pump runs a burst of wavefront ticks, each tick one estimator forward
over every lane's S slots (``S * 2 * lanes`` rows).  The host mirrors each
lane's tick count ``w`` exactly (``w += w < avail``), so a pump runs only
the ticks in which some lane advances, at most ``max_iters``: a tick in
which no lane advances changes nothing, and the JAX package's burst of
``max_iters`` ticks gives the same state and audio.

On CUDA (``graphs=True``, the default) five steps replay as CUDA graphs
(``utils/graphs.StepGraphs``), each reading its per-call values from device
tensors: one wavefront tick (``avail`` and ``k_total`` uploaded once per
pump, the tick index counted on the device, each tick's exit mel and
valid flag written into persistent ``(max_iters, lanes, cf, n_mel)`` and
``(max_iters, lanes)`` buffers), one lane's encoder hop (its lane index a
device scalar), a stream's first vocoder hop (batch 1, its lane index a
device scalar, its mel copied into a persistent input), one batched
steady vocoder hop over every lane and a stream's finalize hop (one graph
per tail length, over the lane's caches sliced into a persistent scratch
cache, its token count a device scalar).  The prefill, the admit-scatter,
the lane slice, the lane clear and a stream's last vocoder hop run
eagerly, once per stream.

The emit phase is tick-major.  For each tick of the burst in which some
lane hands out a steady chunk, one replay of the vocoder hop runs every
lane as a row of ``vocode_hop`` (the NSF draws shared, as the rows of a
lockstep session share them): it reads the tick's mels from the burst
buffer at a device tick index, writes the wav rows into a persistent
``(max_iters, lanes, cf * u)`` buffer, and updates the vocoder caches of
the lanes that emit a steady chunk at that tick, the other rows' caches
left bit for bit as they were (a per-(tick, lane) mask built from the
valid flags, uploaded with the ticks once per pump).  A stream's first
chunk takes the first hop at its tick instead, and its finalize
tail runs after its last steady chunk, so each lane's audio is the same
sequence of hops as one lane vocoded alone.  These replays, at most one
per tick, take the place of the JAX package's ``_voc_take_scan`` (a scan
over a burst's chunks of one lane).  The host fetches the burst's valid
flags once per pump and the burst's steady audio in one copy per pump.

Telemetry (``utils/profiling.TELEMETRY``): each pump is a span
``batcher.pump`` with the children ``batcher.encode`` (the deferred
prefills and encoder hops), ``batcher.wave`` (the tick replays and the
flags fetch) and ``batcher.emit`` (the vocoder hops and audio copies; each
lane's finalize tail a ``batcher.finalize`` inside it), each with its
device time between CUDA events at its edges.  The counters
``batcher.ticks``, ``batcher.rows_computed`` (S x 2 x lanes a tick),
``batcher.rows_useful`` (the rows whose ring write is enabled, counted
from the host mirror), ``batcher.voc_replays`` (batched steady vocoder
hops) and ``batcher.voc_rows`` (steady lane-chunks vocoded by them) grow
once per pump; a lane keeps the ticks run from its prefill to its first
chunk handed out (``first_ticks``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.flow.kv_stream import (
    dyn_slice, est_cache_from_flat, est_cache_to_flat, extend_rings_for_fused,
    fuse_qkv_params, group_estimator_params, init_est_pool, init_kv_cache,
    kv_flow_encode_step, kv_flow_step, noise_chunk, pe_tables,
    shrink_rings_from_fused, spk_embedding, tensor_leaves, ungroup_est_flat,
    wave_lanes_step, wave_lanes_step_kernel)
from ..utils.flops import DispatchMeter
from ..utils.graphs import StepGraphs
from ..utils.profiling import TELEMETRY
from .kv_session import KVVocState, estimator_kernel_limit, vocode_hop


def _pairs(a: Dict, b: Dict):
    """(a leaf, b leaf) pairs of two nested dicts with the same keys."""
    for k, v in a.items():
        if isinstance(v, dict):
            yield from _pairs(v, b[k])
        else:
            yield v, b[k]


def _voc_fields(voc: KVVocState):
    return voc.mel_cache, voc.source_cache, voc.speech_cache


class _Lane:
    """Host-side bookkeeping of one lane's stream."""

    def __init__(self):
        self.active = False

    def reset(self, prompt_len: int, cap: int) -> None:
        self.active = True
        self.prompt_len = prompt_len
        self.n_tok = prompt_len           # tokens through the encoder
        self.tokens = np.zeros((cap,), np.int32)
        self.n_pushed = 0
        self.finished = False
        self.k_total: Optional[int] = None
        self.chunks_encoded = 0
        self.w_emitted = 0
        self.w_host = 0                   # host mirror of the device w
        self.first_voc = True
        self.prefilled = False
        self.tick0 = None                 # batcher ticks at the prefill
        self.first_ticks = None           # ticks run to the first chunk
        self.ptok = self.pfeat = self.emb = None   # device tensors, at admit


class KVContinuousBatcher:
    """Fixed-lane continuous batcher over one ``AudioDecoder``'s modules.

    Protocol per lane: ``admit(prompt...) -> lane``, ``push(lane, tokens)``
    any number of times, ``finish(lane)``, then ``pump()`` until the lane's
    stream ends (the pump that returns its last chunk, the finalize tail
    included, frees the lane).  ``pump(max_iters)`` advances every active
    lane by up to ``max_iters`` wavefront ticks and returns {lane: float32
    wav chunk (1, samples)}.

    ``kernel="auto"`` runs the estimator's groups through ``fused_tf_group``
    when ``fused_block.kernel_limit`` accepts the down, mid and up groups at
    the pool's ring (on the CPU its wrapper runs the plain version);
    ``kernel=True`` raises a ValueError naming the limit where it does not.
    ``graphs`` replays the wavefront tick, the encoder hop, a stream's
    first vocoder hop, the batched steady vocoder hop and the finalize hop
    as CUDA graphs on a CUDA device.  ``ticks`` counts the wavefront ticks
    run.  ``fused=False`` runs the concat dataflow; ``ring_quant=True``
    (which needs it) keeps the lane rings in int8.
    ``meter`` (``utils/flops.py``), once enabled, counts the graphed steps
    and the eager calls; ``measured_flops()`` sums their FLOPs."""

    def __init__(self, dec, n_lanes: int = 4,
                 block_size: Optional[int] = None,
                 ring_tokens: Optional[int] = None, token_cap: int = 1024,
                 fused: bool = True, ring_quant: bool = False,
                 kernel="auto", graphs: bool = True):
        if ring_quant and fused:
            raise ValueError("ring_quant needs the concat dataflow "
                             "(fused=False)")
        self._quant = bool(ring_quant)
        self.dec = dec
        self._fused = bool(fused)
        self._dataflow = "fused" if self._fused else "concat"
        self.lanes = n_lanes
        self.hop = block_size or dec.pipe_cfg.block_size
        self.ring_tokens = (ring_tokens if ring_tokens is not None
                            else dec.pipe_cfg.max_token_len - self.hop)
        self.la = dec.lookahead
        self.ratio = dec.ratio
        self.cap = token_cap
        cfg = self.cfg = dec.flow_cfg
        self.n_mel = cfg.output_size
        self.cf = self.hop * self.ratio
        self.s_steps = cfg.cfm.n_timesteps
        self.mel_cache_len = dec.pipe_cfg.mel_cache_len
        self.scl = dec.source_cache_len
        self.dev = dec.device
        self.dt = dec._dt()
        self.est_dt = dec.estimator_dtype or self.dt
        # the pool's ring capacity: ring + chunk for the fused dataflow,
        # the canonical ring for the concat one
        self.rp = self.ring_tokens * self.ratio + (self.cf if self._fused
                                                   else 0)

        est_cfg = cfg.estimator
        why = estimator_kernel_limit(est_cfg, self.cf, self.rp, self.est_dt)
        if est_cfg.act_fn != "gelu":
            why = f"the kernel runs exact GELU, not {est_cfg.act_fn!r}"
        if not self._fused:
            why = "the kernel writes before it attends (fused=True)"
        if kernel == "auto":
            kernel = why is None
        if kernel and why:
            raise ValueError(f"the lanes kernel engine cannot run this "
                             f"geometry: {why}")
        self._kernel = bool(kernel)
        self.meter = DispatchMeter()
        self._steps = StepGraphs(self.dev, graphs, self.meter)
        self._graphs = self._steps.enabled

        self._fw = getattr(dec, "_fused_qkv", None)
        if self._fw is None:
            self._fw = dec._fused_qkv = fuse_qkv_params(dec.flow)
        self._gp = None
        if self._kernel:
            self._gp = getattr(dec, "_grouped_est_params", None)
            if self._gp is None:
                self._gp = dec._grouped_est_params = group_estimator_params(
                    dec.flow, self._fw)
        self._pe_tok, self._pe_mel = pe_tables(cfg, token_cap + 64, self.dev)
        win = torch.from_numpy(np.hamming(2 * self.scl).astype(np.float32))
        self._fade_in = win[: self.scl].to(self.dev)
        self._fade_out = win[self.scl:].to(self.dev)
        self._alloc()
        self._lanes: List[_Lane] = [_Lane() for _ in range(n_lanes)]

    # ------------------------------------------------------------- pools
    def _alloc(self) -> None:
        """The persistent device pools; every graph reads and writes these
        addresses."""
        dev, lanes, s, cf, n_mel = (self.dev, self.lanes, self.s_steps,
                                    self.cf, self.n_mel)
        cfg = self.cfg
        self._est_g = init_est_pool(cfg, s * 2 * lanes, self.rp, self.est_dt,
                                    dev, quant=self._quant)
        self._est = ungroup_est_flat(self._est_g, cfg.estimator)
        sd = (torch.float32 if cfg.cfm.solver_dtype == "float32"
              else self.dt)
        self._x = torch.zeros((s, lanes, cf, n_mel), dtype=sd, device=dev)
        self._mu = torch.zeros((s, lanes, cf, n_mel), dtype=self.est_dt,
                               device=dev)
        self.mu_cap = max(2 * s, (self.cap + self.hop - 1) // self.hop + 2)
        self._mu_buf = torch.zeros((lanes, self.mu_cap, cf, n_mel),
                                   dtype=self.est_dt, device=dev)

        def longs(*shape):
            return torch.zeros(shape, dtype=torch.long, device=dev)
        self._w, self._base = longs(lanes), longs(lanes)
        self._spks = torch.zeros((lanes, n_mel), dtype=self.dt, device=dev)
        # avail (row 0) and k_total (row 1): one upload per pump
        self._ak = longs(2, lanes)
        self._tok = longs(lanes, self.cap + self.hop + self.la + 1)
        # a batch-1 canonical cache for a lane's prefill and finalize hop
        self._scratch = init_kv_cache(cfg, self.ring_tokens, dtype=self.dt,
                                      est_dtype=self.est_dt, device=dev,
                                      est_quant=self._quant)
        self._scratch_flat = est_cache_to_flat(self._scratch["est"])
        # per-lane encoder caches (leading lane axis), token counts and
        # prompt lengths
        self._enc = {k: torch.zeros((lanes,) + tuple(v.shape), dtype=v.dtype,
                                    device=dev)
                     for k, v in self._scratch["enc"].items()}
        self._n_tok, self._plen = longs(lanes), longs(lanes)
        # the finalize hop's other operands
        self._fin_tok = longs(1, self.hop + self.la)
        self._fin_emb = torch.zeros((1, cfg.spk_embed_dim), dtype=self.dt,
                                    device=dev)
        self._fin_ntok = longs()
        self._fin_out: Dict[int, torch.Tensor] = {}   # tail -> mel
        # per-lane vocoder caches, and the batched steady vocoder hop's
        # operands: every lane's mel, its audio, the lanes whose caches it
        # updates
        self._voc_pool = KVVocState(
            torch.zeros((lanes, self.mel_cache_len, n_mel), device=dev),
            torch.zeros((lanes, self.scl, 1), device=dev),
            torch.zeros((lanes, self.scl), device=dev))
        self._voc_in = torch.zeros((lanes, cf, n_mel), device=dev)
        u = self.dec.hift_cfg.total_upsample
        self._voc_out = torch.zeros((lanes, cf * u), device=dev)
        self._voc_keep = torch.zeros((lanes,), dtype=torch.bool, device=dev)
        # a stream's first vocoder hop: one lane's mel and audio
        self._first_in = torch.zeros((1, cf, n_mel), device=dev)
        self._first_out = torch.zeros((1, cf * u - self.scl), device=dev)
        self._voc_draws = self._first_draws = None    # made at use
        self._all_lanes = torch.arange(lanes, device=dev)
        # the lane of an encoder hop or a first vocoder hop (entry 0), the
        # rows of a steady vocoder hop (every lane)
        self._lane_idx = longs(lanes)
        self._tick = longs(1)               # the tick of a burst
        self._voc_k = longs(1)              # the vocoder replay of a burst
        # made at use, with max_iters rows: (mels, oks) of the ticks; the
        # steady audio of the ticks; a row per vocoder replay: its tick,
        # then its lanes' cache-update flags
        self._burst_out = self._voc_wav = self._voc_plan = None
        self._emit_t = 0                    # the tick being handed out
        self.ticks = 0

    def _lane_view(self, pool: torch.Tensor, lane: int) -> torch.Tensor:
        """(S * 2 * lanes, ...) flat pool leaf -> lane's (S, 2, ...) rows."""
        v = pool.view((self.s_steps, 2, self.lanes) + tuple(pool.shape[1:]))
        return v[:, :, lane]

    def _lane_leaves(self, est: Dict):
        """(pool leaf, lane-sized leaf) pairs of two flat est caches: the
        rings (both leaves of an int8 ring), then the conv caches."""
        yield from zip(tensor_leaves(self._est["kv"]),
                       tensor_leaves(est["kv"]))
        yield from _pairs(self._est["convs"], est["convs"])

    # ------------------------------------------------------------- steps
    def _tick_impl(self) -> None:
        """One wavefront tick on the pools (the body of the JAX package's
        ``_burst_impl``): its exit mels and valid flags into row ``_tick``
        of the burst's buffers, then ``_tick`` += 1."""
        mels, oks = self._burst_out
        avail, k_total = self._ak[0], self._ak[1]
        dec = self.dec.flow.decoder
        if self._kernel:
            mel, ok, x, mu, w = wave_lanes_step_kernel(
                self._gp, dec, self._x, self._mu, self._mu_buf, self._spks,
                self._est_g, self._w, avail, k_total, self._base)
        else:
            mel, ok, x, mu, w = wave_lanes_step(
                dec, self._fw, self._x, self._mu, self._mu_buf, self._spks,
                self._est, self._w, avail, k_total, self._base,
                self._dataflow)
        self._x.copy_(x)
        self._mu.copy_(mu)
        self._w.copy_(w)
        mels.index_copy_(0, self._tick, mel[None])
        oks.index_copy_(0, self._tick, ok[None])
        self._tick.add_(1)

    def _enc_hop_impl(self) -> None:
        """One encoder hop of the lane at ``_lane_idx`` (the JAX package's
        ``_enc_hops_impl`` body): its next chunk and lookahead at its device
        token count, its encoder caches, mu into its chunk slot."""
        lane = self._lane_idx[:1]
        enc = {k: v.index_select(0, lane)[0] for k, v in self._enc.items()}
        n_tok = self._n_tok.index_select(0, lane).reshape(())
        off = n_tok - self._plen.index_select(0, lane).reshape(())
        seg = dyn_slice(self._tok.index_select(0, lane), off,
                        self.hop + self.la, dim=1)
        mu, enc = kv_flow_encode_step(
            self.dec.flow, self._fw, seg[:, :self.hop], seg[:, self.hop:],
            enc, n_tok, self._pe_tok, self._pe_mel)
        for k, v in self._enc.items():
            v.index_copy_(0, lane, enc[k][None].to(v.dtype))
        slot = torch.remainder(torch.div(off, self.hop, rounding_mode="floor"),
                               self.mu_cap)
        self._mu_buf.view((-1,) + tuple(self._mu_buf.shape[2:])).index_copy_(
            0, lane * self.mu_cap + slot, mu.to(self._mu_buf.dtype))
        self._n_tok.index_copy_(0, lane, (n_tok + self.hop).reshape(1))

    def _voc_state(self, lane) -> KVVocState:
        """The vocoder caches of ``lane`` (a host int), or of the lanes a
        device index tensor lists."""
        pools = _voc_fields(self._voc_pool)
        if torch.is_tensor(lane):
            return KVVocState(*(a.index_select(0, lane) for a in pools))
        return KVVocState(*(a[lane:lane + 1] for a in pools))

    def _vocode(self, emit_mel, voc: KVVocState, first: bool,
                finalize: bool, draws=None):
        return vocode_hop(self.dec.hift, self._fade_in, self._fade_out,
                          self.mel_cache_len, self.dt, emit_mel, voc, first,
                          finalize, draws)

    def _voc_step_impl(self) -> None:
        """One steady vocoder hop of the lanes at ``_lane_idx`` (every lane,
        one row each) over their mels in ``_voc_in``: the audio into
        ``_voc_out``, the caches of the lanes ``_voc_keep`` flags updated,
        the other lanes' caches left as they were."""
        lane = self._lane_idx
        old = self._voc_state(lane)
        wav, new = self._vocode(self._voc_in, old, False, False,
                                self._voc_draws)
        self._voc_out.copy_(wav)
        for pool, was, v in zip(_voc_fields(self._voc_pool), _voc_fields(old),
                                _voc_fields(new)):
            keep = self._voc_keep.view((-1,) + (1,) * (v.dim() - 1))
            pool.index_copy_(0, lane, torch.where(keep, v.to(pool.dtype), was))

    def _voc_first_impl(self) -> None:
        """A stream's first vocoder hop (no caches, no cross-fade) over the
        chunk in ``_first_in``: the audio into ``_first_out``, the caches of
        the lane at ``_lane_idx[0]`` set."""
        lane = self._lane_idx[:1]
        wav, new = self._vocode(self._first_in, None, True, False,
                                self._first_draws)
        self._first_out.copy_(wav)
        for pool, v in zip(_voc_fields(self._voc_pool), _voc_fields(new)):
            pool.index_copy_(0, lane, v.to(pool.dtype))

    def _make_draws(self) -> None:
        """The NSF draws of the first and the steady vocoder hops (HiFT's
        own, for their lengths), made once: a graph reads them."""
        if self._voc_draws is None:
            h, u = self.dec.hift, self.dec.hift_cfg.total_upsample
            harmonics = h.cfg.nb_harmonics + 1
            self._first_draws = h.draws(harmonics, self.cf * u, self.dev)
            self._voc_draws = h.draws(
                harmonics, (self.mel_cache_len + self.cf) * u, self.dev)

    def _voc_hop_impl(self) -> None:
        """The burst's next batched steady vocoder hop (replay ``_voc_k`` of
        the pump, counted on the device): its row of ``_voc_plan`` names
        the tick, whose mels ``_voc_in`` takes from the burst buffer, and
        the lanes whose caches the hop updates; ``_voc_step_impl``; its
        audio into the tick's row of ``_voc_wav``; then ``_voc_k`` += 1."""
        plan = self._voc_plan.index_select(0, self._voc_k)[0]
        tick = plan[:1]
        self._voc_in.copy_(self._burst_out[0].index_select(0, tick)[0])
        self._voc_keep.copy_(plan[1:] != 0)
        self._voc_step_impl()
        self._voc_wav.index_copy_(0, tick, self._voc_out[None])
        self._voc_k.add_(1)

    # ----------------------------------------------------------- lifecycle
    @torch.inference_mode()
    def admit(self, prompt_token: np.ndarray, prompt_feat: np.ndarray,
              embedding: np.ndarray) -> int:
        """Claims a free lane for a new stream; returns the lane id.  The
        prompt prefill waits for the first ``la`` stream tokens (the
        prompt's pre-lookahead conv reads them as context) or for
        ``finish``."""
        lane = next((i for i, st in enumerate(self._lanes)
                     if not st.active), None)
        if lane is None:
            raise RuntimeError("no free lane")
        st = self._lanes[lane]
        st.reset(int(prompt_token.shape[1]), self.cap)
        st.ptok = torch.as_tensor(np.asarray(prompt_token),
                                  dtype=torch.long).to(self.dev)
        st.pfeat = torch.as_tensor(np.asarray(prompt_feat, np.float32)).to(
            self.dev, self.dt)
        st.emb = torch.as_tensor(np.asarray(embedding, np.float32)).to(
            self.dev, self.dt)
        return lane

    def _prefill(self, lane: int, st: _Lane) -> None:
        """The lane's prompt prefill (eager) and the admit-scatter of its
        caches into the pools (the JAX package's ``_maybe_prefill`` and
        ``_admit_scatter_impl``)."""
        flow, sc = self.dec.flow, self._scratch
        for t in list(tensor_leaves(sc["enc"])) + list(
                tensor_leaves(sc["est"])):
            t.zero_()
        enc = sc["enc"]
        if st.prompt_len:
            ctx = torch.as_tensor(st.tokens[None, :self.la],
                                  dtype=torch.long).to(self.dev)
            _, new = self.meter.call(
                ("prefill", st.prompt_len), lambda: kv_flow_step(
                    flow, self._fw, st.ptok, ctx, st.pfeat, st.emb, sc,
                    self._pe_tok, self._pe_mel))
            enc = new["enc"]
        for k, v in self._enc.items():
            v[lane].copy_(enc[k])
        self._n_tok[lane] = st.prompt_len
        self._plen[lane] = st.prompt_len
        # canonical capacity-R rings -> the pool's layout: extended, rot 0,
        # for the fused dataflow; as they are for the concat one
        base = st.prompt_len * self.ratio
        ext = est_cache_to_flat(sc["est"])
        if self._fused:
            ext = extend_rings_for_fused(ext, base, self.cf, 0)
        for pool, leaf in self._lane_leaves(ext):
            self._lane_view(pool, lane).copy_(
                leaf.view((self.s_steps, 2) + tuple(leaf.shape[1:])))
        self._x[:, lane].zero_()
        self._x[0, lane].copy_(noise_chunk(flow.decoder, base, self.cf,
                                           self.n_mel, self.dev))
        self._mu[:, lane].zero_()
        self._mu_buf[lane].zero_()
        self._w[lane] = 0
        self._spks[lane].copy_(self.meter.call(
            ("spk",), lambda: spk_embedding(flow, st.emb))[0])
        self._base[lane] = base
        st.prefilled = True
        st.tick0 = self.ticks

    @torch.inference_mode()
    def push(self, lane: int, tokens: np.ndarray) -> None:
        """Appends tokens to the lane's stream: one upload."""
        st = self._lanes[lane]
        if not st.active or st.finished:
            raise RuntimeError(f"lane {lane} takes no tokens")
        tokens = np.asarray(tokens).reshape(-1).astype(np.int32)
        n0, n = st.n_pushed, len(tokens)
        if n0 + n > self.cap:
            raise ValueError(f"lane {lane}: {n0 + n} tokens exceed "
                             f"token_cap {self.cap}")
        st.tokens[n0:n0 + n] = tokens
        st.n_pushed = n0 + n
        self._tok[lane, n0:n0 + n].copy_(torch.from_numpy(tokens))

    def finish(self, lane: int) -> None:
        st = self._lanes[lane]
        if not st.active or st.finished:
            raise RuntimeError(f"lane {lane} is not streaming")
        st.finished = True
        st.k_total = max(0, (st.n_pushed - self.la) // self.hop)

    # ----------------------------------------------------------------- pump
    def _encodable(self, st: _Lane) -> int:
        return (st.k_total if st.finished
                else max(0, (st.n_pushed - self.la) // self.hop))

    def _encode_available(self) -> None:
        """The deferred prefills, then one encoder hop per newly encodable
        chunk of every lane."""
        for lane, st in enumerate(self._lanes):
            if not st.active:
                continue
            if not st.prefilled and (st.n_pushed >= self.la or st.finished):
                self._prefill(lane, st)
            if not st.prefilled:
                continue
            n_new = self._encodable(st) - st.chunks_encoded
            if n_new <= 0:
                continue
            # chunk k stays at slot k % mu_cap until the wavefront reads it
            if st.chunks_encoded + n_new - st.w_host > self.mu_cap:
                raise RuntimeError("mu chunk ring overrun: pump more often "
                                   "or raise token_cap")
            self._lane_idx.fill_(lane)
            for _ in range(n_new):
                self._steps.run(("enc",), self._enc_hop_impl)
            st.n_tok += n_new * self.hop
            st.chunks_encoded += n_new

    @torch.inference_mode()
    def pump(self, max_iters: int = 8) -> Dict[int, np.ndarray]:
        """Advances all lanes by up to ``max_iters`` wavefront ticks; returns
        {lane: wav float32 (1, samples)} for lanes that emitted audio, and
        frees the lanes whose stream ended (their last chunk includes the
        finalize tail)."""
        with TELEMETRY.span("batcher.pump"):
            return self._pump(max_iters)

    def _alloc_burst(self, max_iters: int) -> None:
        """The burst's buffers for ``max_iters`` ticks; the graphs that
        read the old ones are dropped."""
        dev, lanes = self.dev, self.lanes
        self._burst_out = (
            torch.zeros((max_iters, lanes, self.cf, self.n_mel), device=dev),
            torch.zeros((max_iters, lanes), dtype=torch.bool, device=dev))
        self._voc_wav = torch.zeros((max_iters,) + tuple(self._voc_out.shape),
                                    device=dev)
        self._voc_plan = torch.zeros((max_iters, 1 + lanes), dtype=torch.long,
                                     device=dev)
        for key in (("tick",), ("voc",)):
            self._steps.graphs.pop(key, None)

    def _useful_rows(self, live, ak: np.ndarray, n_ticks: int) -> int:
        """The rows of the next ``n_ticks`` ticks whose ring write is
        enabled (the kernel's per-row write flag), from the host mirror:
        at tick index w an advancing lane (w < avail) writes its steps s
        with 0 <= s < S and 0 <= w - s < k_total, min(S, w + 1) -
        max(0, w - k_total + 1) steps, two CFG rows each."""
        s_steps = self.s_steps

        def upto(n, k):   # the steps written over tick indices 0 .. n - 1
            m = min(n, s_steps)
            tail = max(0, n - k)
            return (m * (m + 1) // 2 + (n - m) * s_steps
                    - tail * (tail + 1) // 2)

        rows, avail = 0, ak[0].tolist()
        for lane, st in live:
            w0 = st.w_host
            w1 = min(w0 + n_ticks, avail[lane])
            if w1 > w0:
                k = st.k_total if st.finished else w1   # no tail before w1
                rows += upto(w1, k) - upto(w0, k)
        return 2 * rows

    def _pump(self, max_iters: int) -> Dict[int, np.ndarray]:
        tel, dev = TELEMETRY, self.dev
        with tel.span("batcher.encode", device=dev):
            self._encode_available()
        ak = np.zeros((2, self.lanes), np.int64)
        ak[1] = 1 << 30
        live = [(lane, st) for lane, st in enumerate(self._lanes)
                if st.active and st.prefilled]
        if not live:
            return {}
        for lane, st in live:
            if st.finished:
                ak[:, lane] = (st.k_total + self.s_steps - 1, st.k_total)
            else:
                ak[0, lane] = st.chunks_encoded
        # the ticks in which some lane advances; the host mirror of the
        # device rule w += (w < avail)
        n_ticks = min(max_iters, max(int(ak[0, lane]) - st.w_host
                                     for lane, st in live))
        if n_ticks and tel.enabled:
            tel.count("batcher.ticks", n_ticks)
            tel.count("batcher.rows_computed",
                      self.s_steps * 2 * self.lanes * n_ticks)
            tel.count("batcher.rows_useful",
                      self._useful_rows(live, ak, n_ticks))
        for lane, st in live:
            st.w_host = min(st.w_host + n_ticks, int(ak[0, lane]))
        self._ak.copy_(torch.from_numpy(ak))
        oks_np = np.zeros((0, self.lanes), bool)
        with tel.span("batcher.wave", device=dev):
            if n_ticks:
                if self._burst_out is None or \
                        self._burst_out[0].shape[0] < max_iters:
                    self._alloc_burst(max_iters)
                self._tick.zero_()
                for _ in range(n_ticks):
                    self._steps.run(("tick",), self._tick_impl)
                self.ticks += n_ticks
                oks_np = self._burst_out[1][:n_ticks].cpu().numpy()
        out: Dict[int, np.ndarray] = {}
        with tel.span("batcher.emit", device=dev):
            # each lane's segments in order: the wav of its first hop, or
            # the tick of a steady chunk (a row of the burst's audio)
            segs: Dict[int, list] = {}
            steady = np.zeros(oks_np.shape, bool)
            for t, lane in zip(*np.nonzero(oks_np)):        # tick-major
                t, lane = int(t), int(lane)
                st = self._lanes[lane]
                if not st.active:
                    continue
                self._emit_t = t
                wav = self._emit(lane, st, self._burst_out[0][t, lane][None])
                steady[t, lane] = wav is None
                segs.setdefault(lane, []).append(t if wav is None else wav)
            burst = self._vocode_burst(steady) if steady.any() else None
            for lane, st in enumerate(self._lanes):
                if not st.active:
                    continue
                parts = [burst[s, lane][None] if isinstance(s, int)
                         else s.cpu().numpy() for s in segs.get(lane, ())]
                if st.finished and st.w_emitted >= st.k_total:
                    with tel.span("batcher.finalize", device=dev):
                        parts.extend(w.cpu().numpy() for w in
                                     self._finalize_lane(lane, st))
                    st.active = False
                if parts:
                    out[lane] = np.concatenate(parts, axis=1)
                    if st.first_ticks is None:
                        st.first_ticks = self.ticks - st.tick0
        return out

    def _emit(self, lane: int, st: _Lane,
              mel: torch.Tensor) -> Optional[torch.Tensor]:
        """Vocodes one wavefront chunk of the lane, handed out at tick
        ``_emit_t`` of the burst: the stream's first through the (graphed)
        first hop (returns its wav); a steady one is staged for the tick's
        batched hop (returns None), which reads it from its slot of the
        burst buffer, where the wavefront wrote it (a chunk handed in from
        elsewhere is copied there)."""
        st.w_emitted += 1
        if st.first_voc:
            st.first_voc = False
            self._make_draws()
            self._first_in.copy_(mel)
            self._lane_idx.fill_(lane)
            self._steps.run(("voc_first",), self._voc_first_impl)
            return self._first_out.clone()
        slot = self._burst_out[0][self._emit_t, lane]
        if mel.data_ptr() != slot.data_ptr():
            slot.copy_(mel.reshape(slot.shape))
        return None

    def _vocode_burst(self, steady: np.ndarray) -> np.ndarray:
        """The burst's steady chunks, ``steady`` (ticks, lanes) flags from
        the host mirror: one batched vocoder hop per tick that has one (the
        plan uploaded once), then the audio of the burst's ticks in one
        copy, (ticks, lanes, samples) float32 on the host."""
        self._make_draws()
        ticks = np.nonzero(steady.any(axis=1))[0]
        plan = np.zeros(tuple(self._voc_plan.shape), np.int64)
        plan[:len(ticks), 0] = ticks
        plan[:len(ticks), 1:] = steady[ticks]
        self._voc_plan.copy_(torch.from_numpy(plan))
        self._voc_k.zero_()
        self._lane_idx.copy_(self._all_lanes)
        for _ in ticks:
            self._steps.run(("voc",), self._voc_hop_impl)
        TELEMETRY.count("batcher.voc_replays", len(ticks))
        TELEMETRY.count("batcher.voc_rows", int(steady.sum()))
        return self._voc_wav[:steady.shape[0]].cpu().numpy()

    def _fin_hop_impl(self, tail: int) -> None:
        """The finalize hop of ``tail`` tokens (the JAX package's
        ``_fin_hop_impl``): the per-hop KV step with finalize semantics over
        the lane caches sliced into the scratch cache, at the device token
        count ``_fin_ntok``; the mel into ``_fin_out[tail]``."""
        sc = self._scratch
        cache = {"enc": sc["enc"],
                 "est": est_cache_from_flat(self._scratch_flat, self.s_steps),
                 "n_tok": self._fin_ntok}
        ctx = torch.zeros((1, self.la), dtype=torch.long, device=self.dev)
        cond = torch.zeros((1, tail * self.ratio, self.n_mel), dtype=self.dt,
                           device=self.dev)
        mel, _ = kv_flow_step(self.dec.flow, self._fw,
                              self._fin_tok[:, :tail], ctx, cond,
                              self._fin_emb, cache, self._pe_tok,
                              self._pe_mel, finalize=True)
        self._fin_out[tail].copy_(mel)

    def _finalize_lane(self, lane: int, st: _Lane) -> List[torch.Tensor]:
        """The tail tokens (< hop + la) through the per-hop KV step with
        finalize semantics (graphed per tail length) on the lane's caches,
        sliced out of the pools into the scratch cache (the JAX package's
        ``_lane_slice_impl``: the rings shrunk back to canonical capacity),
        then the lane's pool rows cleared."""
        tail = st.n_pushed - st.k_total * self.hop
        segs = []
        if tail > 0:
            sc = self._scratch
            for k, v in self._enc.items():
                sc["enc"][k].copy_(v[lane])
            n_frames = (st.prompt_len + st.k_total * self.hop) * self.ratio
            def lane_rows(a):
                return self._lane_view(a, lane).reshape(
                    (-1,) + tuple(a.shape[1:]))
            if self._fused:
                shrink_rings_from_fused(
                    {"kv": tuple(lane_rows(a) for a in self._est["kv"]),
                     "convs": {}}, n_frames, self.cf, 0,
                    out=self._scratch_flat["kv"])
            else:
                for leaf, ring in zip(tensor_leaves(self._scratch_flat["kv"]),
                                      tensor_leaves(self._est["kv"])):
                    leaf.copy_(lane_rows(ring))
            for pool, leaf in _pairs(self._est["convs"],
                                     self._scratch_flat["convs"]):
                leaf.copy_(self._lane_view(pool, lane).reshape(leaf.shape))
            off = st.k_total * self.hop
            self._fin_tok[0, :tail].copy_(torch.from_numpy(
                st.tokens[off:off + tail]))
            self._fin_emb.copy_(st.emb)
            self._fin_ntok.fill_(st.n_tok)
            if tail not in self._fin_out:
                self._fin_out[tail] = torch.zeros(
                    (1, tail * self.ratio, self.n_mel), device=self.dev)
            self._steps.run(("fin", tail),
                            functools.partial(self._fin_hop_impl, tail))
            first = st.first_voc
            st.first_voc = False
            wav, _ = self.meter.call(
                ("voc_fin", tail, first), lambda: self._vocode(
                    self._fin_out[tail], None if first else
                    self._voc_state(lane), first, True))
            segs.append(wav)
        for pool, _ in self._lane_leaves(self._est):
            self._lane_view(pool, lane).zero_()
        return segs

    # ------------------------------------------------------------ queries
    def measured_flops(self) -> float:
        """The FLOPs of the steps the batcher ran while ``meter.enabled``
        (``utils/flops.py``): per graph key and eager call, its dispatches x
        the FLOPs of one eager run, the kernels by the JAX package's
        formulas."""
        return self.meter.total_flops()

    @property
    def free_lanes(self) -> int:
        return sum(1 for st in self._lanes if not st.active)

    def has_work(self) -> bool:
        """True when a ``pump()`` would make progress: a pending prefill,
        unencoded pushed chunks, or wavefront ticks left (``w_host`` mirrors
        the device rule exactly, so an engine can sleep instead of pumping
        bursts that advance nothing)."""
        for st in self._lanes:
            if not st.active:
                continue
            if not st.prefilled:
                if st.n_pushed >= self.la or st.finished:
                    return True
                continue
            if self._encodable(st) > st.chunks_encoded:
                return True
            avail = (st.k_total + self.s_steps - 1 if st.finished
                     else st.chunks_encoded)
            if st.w_host < avail:
                return True
        return False
