"""High-level detector API, the torch counterpart of ``ssdx/api.py``.

A :class:`Detector` owns the network, its weights on the device, and the
prior constants; ``predict`` returns the ragged per-image contract (labels
0-based foreground ids, scores, boxes xyxy in 300x300 coordinates).  On the
GPU the serving configuration is ``fold_bn=True, stem_kernel=True,
dtype=torch.bfloat16``: the forward starts with the fused stem kernel and
post-processing runs the NMS kernel.  ``Detector.quantize_int8`` switches
the post-stem backbone to int8 (``ssdx_torch/quant.py``), which on the GPU
runs through the int8 conv kernels (``ssdx_torch/ops/int8_conv.py``).

Host images (a numpy array or a CPU tensor) reach a CUDA detector staged
in pinned host memory: the host casts (or copies) the batch into a buffer
of PyTorch's caching host allocator, which is reused from call to call,
and one asynchronous DMA carries it to the card.  With the stem kernel the
buffer holds bfloat16, what the stem reads: the host's cast rounds to
nearest even, as the card's does, so the stem gets the same bits for half
the bytes across PCIe.  A CUDA tensor, or a detector on the CPU, takes the
plain ``torch.as_tensor(images, device=...)``.
Under a running profiler ``predict_batched``, the input copy and the
network are spans (:func:`ssdx_torch.utils.profiling.span`).
"""
from __future__ import annotations

import numpy as np
import torch

from . import priors as P
from . import quant, resolve_device
from .export import fold_batchnorm
from .mesh import all_gather_batch, shard_batch
from .model import IMAGE_SIZE, SSD300, init_variables
from .ops.int8_conv import apply_int8_kernels
from .ops.stem import stem_conv_pool
from .predict import Detections, postprocess, to_pylist
from .utils.profiling import span
from .weights import load_params, state_dict_from_jax, variables_from_torch

__all__ = ["Detector"]


class Detector:
    """SSD300 detector with a stable user API.

    ``class_to_idx`` maps foreground class names to 0-based ids; background
    is logit column 0 (``num_classes = len(class_to_idx) + 1``).
    ``variables`` is a ``{'params', 'batch_stats'}`` tree in the JAX
    package's layout (:func:`ssdx_torch.weights.load_params`); without it
    the weights are drawn at random from ``rng_seed``.  ``fold_bn`` folds
    BatchNorm into the convs; ``stem_kernel`` (which needs ``fold_bn``) runs
    conv1_1 + conv1_2 + pool through :func:`ssdx_torch.ops.stem.stem_conv_pool`.
    ``device`` defaults to the mesh's device, or without a mesh to ``cuda``.
    ``width_mult`` narrows every backbone layer, for tests.

    ``mesh`` (:mod:`ssdx_torch.mesh`): data-parallel inference.  Every rank
    calls ``forward`` with the same whole batch, runs its shard through the
    stem kernel and the model, and gathers every rank's heads, so each rank
    returns the whole batch's result; SSD inference needs no other
    communication.
    """

    def __init__(
        self,
        class_to_idx: dict[str, int],
        variances: tuple[float, float] = (0.1, 0.2),
        dtype: torch.dtype = torch.float32,
        variables: dict | None = None,
        rng_seed: int = 0,
        fold_bn: bool = False,
        stem_kernel: bool = False,
        device=None,
        width_mult: float = 1.0,
        mesh=None,
    ):
        self.mesh = mesh
        self.device = resolve_device(mesh.device if device is None and mesh is not None
                                     else device)
        self.class_to_idx = dict(class_to_idx)
        self.idx_to_class = {v: k for k, v in class_to_idx.items()}
        self.num_classes = len(class_to_idx) + 1
        self.variances = tuple(variances)
        self.dtype = dtype
        self.fold_bn = fold_bn
        self.width_mult = width_mult
        self.img_h = self.img_w = IMAGE_SIZE

        if variables is None:
            variables = init_variables(self.num_classes, rng_seed, width_mult)
        if fold_bn and "batch_stats" in variables:
            variables = fold_batchnorm(variables)
        self.variables = variables

        self.stem_kernel = bool(stem_kernel and fold_bn)
        self.model = SSD300(self.num_classes, fold_bn=fold_bn,
                            stem_input=self.stem_kernel, width_mult=width_mult,
                            dtype=dtype)
        self.model.load_state_dict(state_dict_from_jax(variables, fold_bn))
        self.model.requires_grad_(False).eval()
        self.model.to(self.device, memory_format=torch.channels_last)

        self.priors = torch.as_tensor(P.create_priors(), device=self.device)
        self.quant_params: quant.QuantizedSSD | None = None
        self._int8_forward = None

    @classmethod
    def from_weights(cls, path, class_to_idx, fold_bn: bool = True, **kwargs) -> "Detector":
        """Load a weights-only export (pickle or ``.npz`` bundle); BatchNorm
        is folded into the convs at load time unless ``fold_bn=False``."""
        blob = load_params(path)
        variables = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
        return cls(class_to_idx, variables=variables, fold_bn=fold_bn, **kwargs)

    def load_train_state(self, state) -> None:
        """Adopt the weights and running statistics of a
        :class:`ssdx_torch.train.step.TrainState` (BN folded when this
        detector serves folded weights).  A quantized detector goes back to
        its float forward: quantize again on the new weights."""
        variables = variables_from_torch(state.model)
        if self.fold_bn:
            variables = fold_batchnorm(variables)
        self.variables = variables
        sd = state_dict_from_jax(variables, self.fold_bn)
        self.model.load_state_dict({k: v.to(self.device) for k, v in sd.items()})
        self.quant_params = self._int8_forward = None

    # ---- int8 quantized serving (ssdx_torch/quant.py) ----

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        """images [B,300,300,3] -> the post-stem map [B,150,150,64]."""
        if self.stem_kernel:
            c0, c1 = self.model.layers[0].conv, self.model.layers[1].conv
            return stem_conv_pool(x, c0.weight, c0.bias, c1.weight, c1.bias, self.dtype)
        return quant.stem_bf16(self.variables["params"], x, self.dtype)

    @torch.inference_mode()
    def quantize_int8(self, calib_images, calib_batch: int = 16, backend: str = "auto") -> dict:
        """Switch this detector's forward to the int8-quantized backbone
        (symmetric int8, per-output-channel weight scales, per-input-channel
        activation scales folded into the weights; ``ssdx_torch/quant.py``).
        The stem and the multibox heads stay in the detector's dtype.

        ``calib_images``: representative normalized images [N,300,300,3]
        (N >= 1) that calibrate the activation scales, taken in chunks of
        ``calib_batch``.  Returns the calibrated per-layer amax[cin] dict.

        ``backend``: "kernel" runs the int8 convs through the hand-written
        GPU kernels (``ops.int8_conv.apply_int8_kernels``), "plain" through
        the PyTorch walk ``quant.apply_int8``; "auto" goes by the detector's
        device: "kernel" on ``cuda``, "plain" on ``cpu``.
        """
        if not self.fold_bn:
            raise ValueError("int8 quantization requires fold_bn=True")
        if backend == "auto":
            backend = "kernel" if self.device.type == "cuda" else "plain"
        if backend not in ("kernel", "plain"):
            raise ValueError(f"backend must be auto, kernel or plain, got {backend!r}")
        if backend == "kernel" and self.device.type != "cuda":
            raise ValueError("backend='kernel' needs a detector on a CUDA device; "
                             f"this one is on {self.device}")
        params = self.variables["params"]
        calib_images = np.asarray(calib_images)
        scales: dict[str, np.ndarray] = {}
        for i in range(0, calib_images.shape[0], calib_batch):
            chunk = torch.as_tensor(calib_images[i : i + calib_batch], device=self.device)
            feats = self._stem(chunk)
            for k, v in quant.calibrate_act_scales(params, feats, self.dtype).items():
                scales[k] = np.maximum(scales[k], v) if k in scales else v
        self.quant_params = quant.quantize_ssd(params, scales, self.num_classes, self.device)
        self._int8_forward = apply_int8_kernels if backend == "kernel" else quant.apply_int8
        return scales

    # ---- inference ----

    @torch.inference_mode()
    def forward(self, images) -> tuple[torch.Tensor, torch.Tensor]:
        """Raw heads: images [B,300,300,3] (normalized, NHWC) ->
        (loc [B,P,4], cls [B,P,C]) float32 on the detector's device.  Once
        :meth:`quantize_int8` has run, the post-stem backbone is int8.

        On a CUDA device, host images (a numpy array or a CPU tensor) are
        staged in pinned memory (:meth:`_stage`): cast on the host to
        bfloat16 when the stem kernel runs (rounding to nearest even, as
        the card would; the stem's own cast is then a no-op), copied as
        they are otherwise.  A CUDA tensor, or a CPU detector, is taken by
        ``torch.as_tensor(images, device=...)``.  The span
        ``ssdx_torch.api.input_copy`` counts the caller's ``input_bytes``
        and the ``staged_bytes`` of them that went through pinned memory.

        With a mesh the batch is zero-padded up to a multiple of the mesh
        size, each rank computes its shard, the shards are gathered in rank
        order and the pad rows are dropped."""
        with span("ssdx_torch.api.input_copy") as sp:
            if self.device.type == "cuda" and (
                    isinstance(images, np.ndarray)
                    or (isinstance(images, torch.Tensor) and images.device.type == "cpu")):
                host = torch.as_tensor(images)
                x = self._stage(host)
                sp.count(input_bytes=host.nbytes, staged_bytes=host.nbytes)
            else:
                x = torch.as_tensor(images, device=self.device)
                sp.count(input_bytes=x.nbytes, staged_bytes=0)
        if self.mesh is None:
            return self._forward_local(x)
        b = x.shape[0]
        pad = (-b) % self.mesh.size
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        loc, conf = self._forward_local(shard_batch(x, self.mesh))
        loc, conf = all_gather_batch(loc, self.mesh), all_gather_batch(conf, self.mesh)
        return loc[:b], conf[:b]

    def _stage(self, host: torch.Tensor) -> torch.Tensor:
        """``host`` on the card through a pinned buffer, in bfloat16 when the
        stem kernel reads it.  The caching host allocator records the DMA's
        event on the buffer and hands it out again only once the DMA is
        done, so concurrent callers never share one.  Returns when the copy
        has landed, as the pageable copy did: the caller's array is free
        again and the input-copy span covers the DMA."""
        dtype = torch.bfloat16 if self.stem_kernel else host.dtype
        pinned = torch.empty(host.shape, dtype=dtype, pin_memory=True).copy_(host)
        x = pinned.to(self.device, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return x

    def _forward_local(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with span("ssdx_torch.api.network"):
            if self._int8_forward is not None:
                return self._int8_forward(self.quant_params, self._stem(x), self.dtype)
            if self.stem_kernel:
                x = self._stem(x)
            return self.model(x)

    @torch.inference_mode()
    def predict_batched(
        self,
        images=None,
        score_thresh: float = 0.2,
        nms_thresh: float = 0.5,
        max_per_img: int = 100,
        class_agnostic: bool = False,
        pre_loc_all=None,
        pre_conf_all=None,
    ) -> Detections:
        """Fixed-shape padded detections (tensors on the detector's device)."""
        with span("ssdx_torch.api.predict_batched"):
            if pre_loc_all is not None and pre_conf_all is not None:
                loc = torch.as_tensor(pre_loc_all, device=self.device)
                conf = torch.as_tensor(pre_conf_all, device=self.device)
            else:
                if images is None:
                    raise ValueError("either images or precomputed logits required")
                loc, conf = self.forward(images)
            return postprocess(
                loc,
                conf,
                self.priors,
                score_thresh=score_thresh,
                nms_thresh=nms_thresh,
                max_per_img=max_per_img,
                class_agnostic=class_agnostic,
                variances=self.variances,
            )

    def predict(self, images=None, **kwargs) -> list[dict]:
        """Ragged predictions: list (len B) of {'labels' int64 0..C-2,
        'scores' float32, 'boxes' [K,4] xyxy in 300x300 pixel coords}."""
        return to_pylist(self.predict_batched(images=images, **kwargs))

    # ---- single-image convenience (serving path) ----

    def preprocess_pil(self, pil_img) -> np.ndarray:
        """EXIF-transpose + resize(300,300, bilinear) + ImageNet normalize;
        returns [1,300,300,3] float32."""
        from PIL import Image, ImageOps

        pil_img = ImageOps.exif_transpose(pil_img.convert("RGB"))
        pil_img = pil_img.resize((IMAGE_SIZE, IMAGE_SIZE), Image.BILINEAR)
        arr = np.asarray(pil_img, np.float32) / 255.0
        mean = np.asarray([0.485, 0.456, 0.406], np.float32)
        std = np.asarray([0.229, 0.224, 0.225], np.float32)
        return ((arr - mean) / std)[None]

    def predict_pil(self, pil_img, **kwargs) -> dict:
        """Predict on one PIL image; returns a single ragged dict."""
        return self.predict(self.preprocess_pil(pil_img), **kwargs)[0]
