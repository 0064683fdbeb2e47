"""PyTorch port of the L-SPINE reproduction, for NVIDIA Hopper (H100).

``repro_torch`` mirrors the module paths and public names of the JAX
package ``repro`` so each function has an obvious counterpart, but it
imports neither JAX nor anything of ``repro``: it keeps its own copies of
the plain-Python pieces (graph specs, numpy packing twins).

Layouts match ``repro`` at every public function: activations are
``(T, B, H, W, C)`` NHWC, conv weights HWIO, packed spike planes
``(T, B, H, W, ceil(C/32))`` int32 LSB-first, conv codes
``(c_out, kh*kw*cin_pad*bits/32)`` int32.

Device rule: the entry points (``deploy``, ``load``, ``SNNServeEngine``,
the launcher) take ``device=`` and default to ``"cuda"``; they raise when
no card is present unless the caller asks for ``device="cpu"``.  Every
kernel wrapper dispatches on its tensor's device: a CPU tensor takes the
plain PyTorch version, a CUDA tensor launches the hand-written CUDA
kernel (kernels/csrc) or raises.  There is no fallback between the two.
"""

from repro_torch.device import resolve_device  # noqa: F401
