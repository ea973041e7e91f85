from .conv import conv2d, conv2d_transpose, max_pool_3x3_s2, pad1_conv4
from .norm import (
    frozen_batch_norm, batch_stats_norm, conditional_batch_stats_norm,
    l2_normalize,
)
from .lstm import lstm_cell, masked_lstm_scan
from .image import mean_pool_2x2, nn_upsample_2x, box_downsample, tf1_resize_bilinear
from .spatial import generate_spatial_batch
from .activations import lrelu, miu_relu, atanh_transform
from .mlstm import (AttnWeightedPixelLSTM, MaskedPixelLSTM,
                    attn_weighted_pixel_lstm, masked_pixel_lstm,
                    mlstm_attn_bwd_cuda, mlstm_attn_bwd_plain, mlstm_attn_cuda,
                    mlstm_attn_plain, mlstm_bwd_cuda, mlstm_bwd_plain,
                    mlstm_cuda, mlstm_plain)
from .recur_attn import (RecurAttnPixelLSTM, recur_attn_bwd_cuda,
                         recur_attn_bwd_plain, recur_attn_cuda,
                         recur_attn_pixel_lstm, recur_attn_plain)
