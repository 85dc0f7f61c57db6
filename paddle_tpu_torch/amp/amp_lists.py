"""AMP op lists (port of ``paddle_tpu/amp/amp_lists.py``; the reference's
``FP16_WHITE_LIST`` / ``FP16_BLACK_LIST``).

White: products that are fast and safe in half precision.
Black: numerically sensitive ops forced to float32.
Everything else runs in whatever dtype its inputs arrive in.
"""

WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "einsum", "bmm", "mm",
    "_sdpa_op", "_flash_attention_op", "bilinear",
}

BLACK_LIST = {
    "exp", "expm1", "log", "log2", "log10", "log1p", "pow", "square",
    "sqrt", "rsqrt", "softmax", "log_softmax", "cross_entropy",
    "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "nll_loss", "kl_div", "mse_loss",
    "l1_loss", "layer_norm", "rms_norm", "_batch_norm_train",
    "_batch_norm_eval", "instance_norm", "group_norm", "local_response_norm",
    "mean", "sum", "cumsum", "cumprod", "logsumexp", "norm", "var", "std",
    "sigmoid_focal_loss", "erf", "erfinv", "cosine_similarity",
}
