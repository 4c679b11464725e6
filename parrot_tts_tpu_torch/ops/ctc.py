"""CTC loss with optax's semantics and torch's 'mean' reduction (the
aligner's objective); port of `parrot_tts_tpu/ops/ctc.py`.

The JAX package calls `optax.ctc_loss`, a log-space forward recursion over
blank states phi (B, N+1) and label states emit (B, N), and divides each
row by its label count before the mean (reference `torch.nn.CTCLoss()`,
`utils/aligner/trainer.py:21,60-63`). This is that recursion in plain
PyTorch, step for step, with its adjoint written out:

- log(0) is `log_epsilon` = -1e5, not -inf, so a row with too few frames
  for its labels (a repeated label needs a blank between) gets a large
  finite loss and a gradient, as in JAX; `torch.nn.functional.ctc_loss`
  gives inf there;
- emissions are log-probs contracted with a one-hot (B, N, V) matrix, not
  gathered: the CUDA backward of a gather is a scatter-add with atomics,
  and a training step must repeat bit for bit. The recursion and its
  adjoint are elementwise ops, slices and copies, so the whole backward
  runs without atomics (torch's CUDA CTC backward has them, and cuDNN's
  CTC takes labels only up to 256);
- optax holds a row's state still on its padded frames; here every row
  runs on to the last frame computed and its loss is read from the state
  at its own length, which is the same value. The adjoint starts each
  row's gradient there, so padded frames get none, and the frames run
  past every row's end change no bit of the result;
- the recursion is ~11 small kernels per frame forward and ~25 back on
  (B, 2N+1) states, written by hand (`_Steps`) rather than recorded by
  autograd, which launches ~80 per frame. On the card the host cannot
  launch them as fast as the device runs them, so a `CTCGraphs` cache,
  when the caller passes one, captures both loops over the whole padded
  T once per (T, B, N, dtype) as CUDA graphs and replays them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LOG_EPSILON = -1e5


class _Steps:
    """The buffers of one recursion over `steps` frames of (T, B, N)
    inputs, and its two loops: `forward` fills the state history from
    emit_lp (T, B, N), blank_lp (T, B, 1) and the transition penalties;
    `backward` turns the gradients at each row's end (`g_end_*`, entered
    at the frame where `ends` (steps + 1, B, 1) is True) into
    g_emit_lp / g_blank_lp."""

    def __init__(self, steps: int, t: int, b: int, n: int, dtype, device):
        def new(*shape):
            return torch.empty(shape, dtype=dtype, device=device)

        self.steps = steps
        self.emit_lp, self.blank_lp = new(t, b, n), new(t, b, 1)
        self.er, self.eo = new(b, n), new(b, n)
        self.phi, self.emit = new(steps + 1, b, n + 1), new(steps + 1, b, n)
        self.pe, self.y = new(steps, b, n + 1), new(steps, b, n + 1)
        self.a1, self.x1, self.x2, self.z = (new(steps, b, n)
                                             for _ in range(4))
        self.ends = torch.empty((steps + 1, b, 1), dtype=torch.bool,
                                device=device)
        self.g_end_phi, self.g_end_emit = new(b, n + 1), new(b, n)
        self.g_emit_lp = torch.zeros((t, b, n), dtype=dtype, device=device)
        self.g_blank_lp = torch.zeros((t, b, 1), dtype=dtype, device=device)

    def forward(self, log_epsilon: float) -> None:
        phi, emit, pe, y = self.phi, self.emit, self.pe, self.y
        a1, x1, x2, z = self.a1, self.x1, self.x2, self.z
        phi[0].fill_(log_epsilon)
        phi[0, :, 0] = 0.0
        emit[0].fill_(log_epsilon)
        for t in range(self.steps):
            le, lp = self.emit_lp[t], self.blank_lp[t]
            # emit -> phi epsilon transition, except into a repeated label
            torch.add(emit[t], self.er, out=a1[t])
            pe[t, :, 0] = phi[t, :, 0]
            torch.logaddexp(phi[t, :, 1:], a1[t], out=pe[t, :, 1:])
            # phi -> emit and the emit self-loop
            torch.add(pe[t, :, :-1], le, out=x1[t])
            torch.add(emit[t], le, out=x2[t])
            torch.logaddexp(x1[t], x2[t], out=emit[t + 1])
            # phi self-loop; emit -> phi blank only before a repeated label
            torch.add(pe[t], lp, out=y[t])
            torch.add(emit[t], lp, out=z[t])
            z[t].add_(self.eo)
            torch.logaddexp(y[t, :, 1:], z[t], out=phi[t + 1, :, 1:])
            phi[t + 1, :, 0] = y[t, :, 0]

    def backward(self) -> None:
        phi, y, z, x1, x2, a1 = self.phi, self.y, self.z, self.x1, self.x2, \
            self.a1
        g_phi = torch.zeros_like(self.g_end_phi)
        g_emit = torch.zeros_like(self.g_end_emit)
        for s in range(self.steps, 0, -1):
            # a row's gradient starts at its own length: assigned, not
            # added, so the states it ran on past its end pass nothing back
            g_phi = torch.where(self.ends[s], self.g_end_phi, g_phi)
            g_emit = torch.where(self.ends[s], self.g_end_emit, g_emit)
            t = s - 1
            # phi' = [y0, logaddexp(y[1:], z)]
            g_y = g_phi.clone()
            g_y[:, 1:].mul_(torch.sigmoid(y[t, :, 1:] - z[t]))
            g_z = g_phi[:, 1:] - g_y[:, 1:]
            # emit' = logaddexp(x1, x2)
            g_x1 = g_emit * torch.sigmoid(x1[t] - x2[t])
            g_x2 = g_emit - g_x1
            torch.add(g_x1, g_x2, out=self.g_emit_lp[t])
            torch.add(g_y.sum(1, keepdim=True), g_z.sum(1, keepdim=True),
                      out=self.g_blank_lp[t])
            # y = pe + lp and x1 = pe[:-1] + le: pe's gradient
            g_y[:, :-1].add_(g_x1)
            # pe = [phi0, logaddexp(phi[1:], a1)], a1 = emit + er
            g_phi = g_y.clone()
            g_phi[:, 1:].mul_(torch.sigmoid(phi[t, :, 1:] - a1[t]))
            g_emit = g_z + g_x2 + (g_y[:, 1:] - g_phi[:, 1:])


class _Captured:
    """A `_Steps` over all T frames and the CUDA graphs of its loops."""

    def __init__(self, t, b, n, dtype, device, log_epsilon):
        self.steps = _Steps(t, t, b, n, dtype, device)
        self.forward, self.backward = (torch.cuda.CUDAGraph(),
                                       torch.cuda.CUDAGraph())
        with torch.cuda.graph(self.forward):
            self.steps.forward(log_epsilon)
        with torch.cuda.graph(self.backward):
            self.steps.backward()
        self.generation = 0


class CTCGraphs:
    """CUDA graphs of the CTC recursion and its adjoint, one pair per
    (T, B, N, dtype, log_epsilon), captured at first use and replayed.
    Each pair owns its buffers (~9 x T x B x (N+1) elements), so a
    forward must be followed by its backward before the next forward of
    the same shape (a backward that finds its buffers reused raises).
    Owned by the caller (the aligner's train state) and freed with it."""

    def __init__(self):
        self._pairs: dict[tuple, _Captured] = {}

    def get(self, t, b, n, dtype, device, log_epsilon) -> _Captured:
        key = (t, b, n, dtype, str(device), log_epsilon)
        if key not in self._pairs:
            self._pairs[key] = _Captured(t, b, n, dtype, device, log_epsilon)
        return self._pairs[key]


class _Recursion(torch.autograd.Function):
    """Per-row CTC loss (B,) from emission log-probs emit_lp (T, B, N) and
    blank log-probs blank_lp (T, B, 1); repeat (B, N) is 1.0 where label
    n+1 repeats label n; lengths, label_lengths (B,) int64 on the device;
    steps: the frames to run (at least the longest length)."""

    @staticmethod
    def forward(ctx, emit_lp, blank_lp, repeat, lengths, label_lengths,
                steps, log_epsilon, graphs):
        t, b, n = emit_lp.shape
        if graphs is not None:
            cap = graphs.get(t, b, n, emit_lp.dtype, emit_lp.device,
                             log_epsilon)
            st = cap.steps
        else:
            cap, st = None, _Steps(steps, t, b, n, emit_lp.dtype,
                                   emit_lp.device)
        st.emit_lp.copy_(emit_lp)
        st.blank_lp.copy_(blank_lp)
        torch.mul(repeat, log_epsilon, out=st.er)  # no epsilon into a repeat
        torch.mul(1.0 - repeat, log_epsilon, out=st.eo)  # blank: repeats only
        if cap is not None:
            cap.forward.replay()
            cap.generation += 1
            ctx.generation = cap.generation
        else:
            st.forward(log_epsilon)
        # each row's last epsilon transition at its own length
        rows = torch.arange(b, device=emit_lp.device)
        has = label_lengths > 0
        ha = st.phi[lengths, rows, label_lengths]
        hc = st.emit[lengths, rows, (label_lengths - 1).clamp(min=0)]
        ctx.st, ctx.cap = st, cap
        ctx.save_for_backward(lengths, label_lengths, has, ha, hc)
        return -torch.where(has, torch.logaddexp(ha, hc), ha)

    @staticmethod
    def backward(ctx, g_loss):
        lengths, ll, has, ha, hc = ctx.saved_tensors
        st, cap = ctx.st, ctx.cap
        if cap is not None and cap.generation != ctx.generation:
            raise RuntimeError("CTCGraphs: another forward of this shape ran "
                               "before this backward and reused its buffers")
        n = st.g_end_emit.shape[1]
        dev = g_loss.device
        g_last = -g_loss
        w = torch.where(has, torch.sigmoid(ha - hc), 1.0)
        torch.mul((torch.arange(n + 1, device=dev)[None] == ll[:, None]),
                  (g_last * w)[:, None], out=st.g_end_phi)
        torch.mul((torch.arange(n, device=dev)[None] == (ll - 1)[:, None]),
                  (g_last * torch.sigmoid(hc - ha) * has)[:, None],
                  out=st.g_end_emit)
        st.ends.copy_((torch.arange(st.ends.shape[0], device=dev)[:, None]
                       == lengths[None, :])[..., None])
        if cap is not None:
            cap.backward.replay()
            return (st.g_emit_lp.clone(), st.g_blank_lp.clone(), None, None,
                    None, None, None, None)
        st.backward()
        return st.g_emit_lp, st.g_blank_lp, None, None, None, None, None, None


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 0, log_epsilon: float = LOG_EPSILON,
             graphs: CTCGraphs | None = None) -> torch.Tensor:
    """Per-row CTC loss (B,) with `optax.ctc_loss`'s recursion on
    right-padded rows: logits (B, T, V); logit_lengths (B,) valid frames;
    labels (B, N) int, right-padded; label_lengths (B,). Without graphs
    the recursion runs to the longest length (read to the host); with
    them, on a CUDA tensor, over all T frames as replayed CUDA graphs."""
    b, t, v = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logits.dtype), (0, 1))
    one_hot = (labels.long()[..., None]
               == torch.arange(v, device=labels.device)).to(logits.dtype)
    emit_lp = torch.bmm(logprobs, one_hot.transpose(1, 2))      # (B, T, N)
    blank_lp = logprobs[:, :, blank_id:blank_id + 1]
    lengths = logit_lengths.long().clamp(max=t)
    label_lens = label_lengths.long().clamp(max=n)
    use_graphs = graphs is not None and logits.is_cuda
    steps = t if use_graphs else int(lengths.max()) if b else 0
    return _Recursion.apply(emit_lp.transpose(0, 1), blank_lp.transpose(0, 1),
                            repeat, lengths, label_lens, steps, log_epsilon,
                            graphs if use_graphs else None)


def ctc_loss_torch_mean(logits: torch.Tensor, logit_lengths: torch.Tensor,
                        labels: torch.Tensor, label_lengths: torch.Tensor,
                        blank_id: int = 0, graphs: CTCGraphs | None = None
                        ) -> torch.Tensor:
    """torch CTCLoss(reduction='mean'): each row's loss over its label
    count (at least 1), then the batch mean. logits (B, T, V)
    unnormalized; logit_lengths (B,) valid frames; labels (B, L) int
    (blank_id never a label); label_lengths (B,). graphs: see ctc_loss."""
    per_seq = ctc_loss(logits, logit_lengths, labels, label_lengths,
                       blank_id=blank_id, graphs=graphs)
    return torch.mean(per_seq / torch.clamp(label_lengths, min=1))
