"""The auto-registered catalog: thunder_tpu's catalog names bound to torch.

thunder_tpu/ops/auto_register.py and ops/auto_catalog_ext.py register
449 long-tail ops (fft, linalg, special, the losses and
activations the frontend does not lower, the view-copy family, ...) as jax
lowerings. The port takes the same names and the same differentiable set,
and binds each name to the torch function of that name, by the convention
the torch frontend looks them up with (interop/torch_frontend.py:
``_auto_catalog_lookup``): ``fft_<name>`` is ``torch.fft.<name>``,
``linalg_<name>`` is ``torch.linalg.<name>``, ``special_<name>`` is
``torch.special.<name>``, and a plain ``<name>`` is
``torch.nn.functional.<name>``, else ``torch.<name>``, else the method
``torch.Tensor.<name>``. The functional form comes first: where both exist
(poisson_nll_loss, ctc_loss, adaptive_max_pool1d, rrelu, ...) it is the one
with torch's documented defaults, which thunder_tpu's lowerings follow.
The jax lowerings are not carried over: torch has the op.

Left out, as ``unbound()`` lists them:

* names of no torch function (thunder_tpu's own helper entries, such as
  ``complex_build`` or ``unfold_dim``, and any name the installed torch
  lacks);
* in-place methods (a name ending in ``_``): a functional program cannot
  hold one;
* ``cpu`` and ``pin_memory``: bound to torch they would move the data to the
  host, and a program runs on one device;
* ``native_batch_norm``: in training mode torch's function writes the
  running statistics in place, a write a functional program cannot hold
  (thunder_tpu's lowering returns them instead).

What thunder_tpu leaves out on purpose stays out here too: ops whose output
shape depends on their data (nonzero, unique, masked_select, bincount),
sparse ops, the RNG samplers and the quantized kernels
(thunder_tpu/ops/auto_catalog_ext.py:13-17)."""
from __future__ import annotations

from typing import Callable

import torch

# thunder_tpu's catalog entries whose gradient is jax.vjp's (its
# JAX_VJP_FALLBACK): here torch.func.vjp's
DIFFERENTIABLE = (
    "absolute", "adaptive_avg_pool1d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
    "adaptive_max_pool1d_with_indices", "adaptive_max_pool2d_with_indices",
    "adaptive_max_pool3d", "adaptive_max_pool3d_with_indices", "addbmm", "addcdiv", "addcmul",
    "addmm", "addmv", "addr", "adjoint", "affine_grid", "affine_grid_generator", "alias_copy",
    "aminmax", "angle", "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctan2",
    "arctanh", "as_strided", "as_strided_copy", "as_strided_scatter", "atleast_1d",
    "atleast_2d", "atleast_3d", "baddbmm", "batch_norm_backward_elemt",
    "batch_norm_backward_reduce", "batch_norm_elemt", "batch_norm_stats",
    "batch_norm_update_stats", "bfloat16", "bilinear", "block_diag", "bmm", "broadcast_tensors",
    "cartesian_prod", "cdist", "cdouble", "celu", "cfloat", "chain_matmul", "chalf",
    "channel_shuffle", "cholesky", "cholesky_inverse", "cholesky_solve", "clip", "column_stack",
    "combinations", "complex", "complex_build", "concat", "concatenate", "conj",
    "conj_physical", "constant_pad_nd", "conv_tbc", "convolution", "corrcoef",
    "cosine_similarity", "cov", "cross", "ctc_loss", "cummax", "cummin", "cumprod",
    "cumulative_trapezoid", "deg2rad", "det", "detach_copy", "diag", "diag_embed", "diagflat",
    "diagonal", "diagonal_copy", "diagonal_scatter", "diff", "dist", "divide", "dot", "double",
    "dsplit", "dstack", "elu", "expand_copy", "fft_fft", "fft_fft2", "fft_fftfreq", "fft_fftn",
    "fft_fftshift", "fft_hfft", "fft_hfft2", "fft_hfftn", "fft_ifft", "fft_ifft2", "fft_ifftn",
    "fft_ifftshift", "fft_ihfft", "fft_ihfft2", "fft_ihfftn", "fft_irfft", "fft_irfft2",
    "fft_irfftn", "fft_rfft", "fft_rfft2", "fft_rfftfreq", "fft_rfftn", "fill", "fix", "fliplr",
    "flipud", "float_power", "floor_divide", "fmax", "fmin", "frac", "frexp", "frobenius_norm",
    "gaussian_nll_loss", "gcd", "ger", "glu", "gradient", "greater", "greater_equal",
    "grid_sample", "grid_sampler", "grid_sampler_2d", "gru", "gru_cell", "half", "hardshrink",
    "hardsigmoid", "hardswish", "hardtanh", "heaviside", "hsplit", "hstack", "hypot", "i0",
    "igamma", "igammac", "imag", "index_fill", "index_reduce", "inner", "inverse", "istft",
    "kron", "kthvalue", "lcm", "ldexp", "lerp", "less", "less_equal", "linalg_cholesky",
    "linalg_cholesky_ex", "linalg_cond", "linalg_cross", "linalg_det", "linalg_diagonal",
    "linalg_eig", "linalg_eigh", "linalg_eigvals", "linalg_eigvalsh",
    "linalg_householder_product", "linalg_inv", "linalg_inv_ex", "linalg_lstsq", "linalg_lu",
    "linalg_lu_factor", "linalg_lu_factor_ex", "linalg_lu_solve", "linalg_matmul",
    "linalg_matrix_exp", "linalg_matrix_norm", "linalg_matrix_power", "linalg_matrix_rank",
    "linalg_multi_dot", "linalg_norm", "linalg_pinv", "linalg_qr", "linalg_slogdet",
    "linalg_solve", "linalg_solve_ex", "linalg_solve_triangular", "linalg_svd",
    "linalg_svdvals", "linalg_tensorinv", "linalg_tensorsolve", "linalg_vander",
    "linalg_vecdot", "linalg_vector_norm", "logaddexp", "logaddexp2", "logcumsumexp", "logdet",
    "logit", "logsigmoid", "lp_pool1d", "lp_pool3d", "lstm", "lstm_cell", "lu", "lu_solve",
    "lu_unpack", "masked_scatter", "matrix_exp", "matrix_exp_", "matrix_power", "matrix_rank",
    "max_pool1d_with_indices", "max_pool2d_with_indices", "max_pool3d_with_indices",
    "max_unpool1d", "max_unpool2d", "max_unpool3d", "median", "meshgrid", "mish", "moveaxis",
    "msort", "multi_margin_loss", "multilabel_margin_loss", "multiply", "mv", "mvlgamma",
    "nanmean", "nanmedian", "nanquantile", "nansum", "narrow", "narrow_copy",
    "native_batch_norm", "native_channel_shuffle", "native_group_norm", "native_layer_norm",
    "native_norm", "negative", "new_empty", "new_full", "new_ones", "new_tensor", "new_zeros",
    "nextafter", "norm_except_dim", "normalize_fn", "not_equal", "nuclear_norm", "orgqr",
    "pairwise_distance", "pdist", "permute_copy", "pinverse", "pixel_shuffle",
    "pixel_unshuffle", "poisson_nll_loss", "polar", "polygamma", "polyval", "positive", "prelu",
    "put", "qr", "quantile", "rad2deg", "ravel", "real", "renorm", "reshape_as", "resolve_conj",
    "resolve_neg", "rnn_relu", "rnn_relu_cell", "rnn_tanh", "rnn_tanh_cell", "rot90",
    "row_stack", "rrelu", "rrelu_eval", "rsub", "scalar_tensor", "scaled_dot_product_attention",
    "scatter_reduce", "select_copy", "select_scatter", "selu", "sgn", "sinc", "slice_copy",
    "slice_scatter", "slogdet", "softplus", "softshrink", "softsign", "special_bessel_j0",
    "special_bessel_j1", "special_betainc", "special_chebyshev_polynomial_t",
    "special_chebyshev_polynomial_u", "special_chebyshev_polynomial_v",
    "special_chebyshev_polynomial_w", "special_digamma", "special_entr", "special_erf",
    "special_erfc", "special_erfcx", "special_erfinv", "special_exp2", "special_expit",
    "special_expm1", "special_gammainc", "special_gammaincc", "special_gammaln",
    "special_hermite_polynomial_h", "special_hermite_polynomial_he", "special_i0",
    "special_i0e", "special_i1", "special_i1e", "special_laguerre_polynomial_l",
    "special_legendre_polynomial_p", "special_log1p", "special_log_ndtr", "special_log_softmax",
    "special_logit", "special_logsumexp", "special_modified_bessel_i0",
    "special_modified_bessel_i1", "special_modified_bessel_k0", "special_modified_bessel_k1",
    "special_multigammaln", "special_ndtr", "special_ndtri", "special_psi", "special_round",
    "special_scaled_modified_bessel_k0", "special_scaled_modified_bessel_k1",
    "special_shifted_chebyshev_polynomial_t", "special_shifted_chebyshev_polynomial_u",
    "special_shifted_chebyshev_polynomial_v", "special_shifted_chebyshev_polynomial_w",
    "special_sinc", "special_softmax", "special_spherical_bessel_j0", "special_xlog1py",
    "special_xlogy", "special_zeta", "split_copy", "split_with_sizes", "split_with_sizes_copy",
    "squeeze_copy", "std_mean", "stft", "subtract", "sum_to_size", "svd", "swapaxes",
    "swapdims", "t_copy", "take", "tanhshrink", "tensordot", "threshold", "trace",
    "transpose_copy", "trapezoid", "trapz", "triangular_solve", "tril",
    "triplet_margin_with_distance_loss", "triu", "true_divide_", "unbind_copy", "unfold_copy",
    "unfold_dim", "unsafe_chunk", "unsafe_split", "unsafe_split_with_sizes", "unsqueeze_copy",
    "unwrap", "upsample", "upsample_bilinear", "upsample_nearest", "vander", "var_mean", "vdot",
    "view_as_complex", "view_as_complex_copy", "view_as_real", "view_as_real_copy", "view_copy",
    "vsplit", "vstack",
)

NON_DIFFERENTIABLE = (
    "allclose", "argwhere_size", "as_tensor", "asarray", "bartlett_window",
    "batch_norm_gather_stats", "batch_norm_gather_stats_with_counts", "blackman_window", "bool",
    "bucketize", "byte", "char", "count_nonzero", "cpu", "empty_permuted", "empty_strided",
    "equal", "fake_quantize_per_channel_affine", "fake_quantize_per_tensor_affine",
    "float_power_int", "geqrf", "hamming_window", "hann_window", "histc", "histogram",
    "histogramdd", "int", "is_same_size", "isclose", "isin", "isneginf", "isposinf", "isreal",
    "kaiser_window", "mode", "nonzero_static", "ormqr", "pca_lowrank", "pin_memory", "range",
    "searchsorted", "short", "svd_lowrank", "tril_indices", "triu_indices", "unravel_index",
)

_HOST_MOVES = ("cpu", "pin_memory")
_IN_PLACE_WRITERS = ("native_batch_norm",)


def resolve(name: str) -> Callable | None:
    """The torch function a catalog name stands for, or None."""
    for fam in ("fft", "linalg", "special"):
        if name.startswith(fam + "_"):
            fn = getattr(getattr(torch, fam), name[len(fam) + 1:], None)
            if fn is not None:
                return fn
    if name.endswith("_") or name in _HOST_MOVES or name in _IN_PLACE_WRITERS:
        return None
    for ns in (torch.nn.functional, torch, torch.Tensor):
        fn = getattr(ns, name, None)
        if fn is not None and callable(fn):
            return fn
    return None


def catalog() -> dict:
    """name -> (torch function, differentiable) for every bound entry."""
    out = {}
    for names, differentiable in ((DIFFERENTIABLE, True), (NON_DIFFERENTIABLE, False)):
        for name in names:
            fn = resolve(name)
            if fn is not None:
                out[name] = (fn, differentiable)
    return out


def unbound() -> list:
    """The catalog names that bind to no torch function (see above)."""
    return sorted(n for n in DIFFERENTIABLE + NON_DIFFERENTIABLE if resolve(n) is None)
