from .fused_bottleneck import (fold_bn_into_conv, fuse_stage_params,
                               fused_stage1, fused_stage1_reference,
                               resnet50_fused_infer,
                               stage1_params_from_state_dict)
from .int8_bottleneck import (int8_block, int8_block_reference,
                              quantize_trunk_blocks, resnet50_int8_block_infer)
from .qat import fake_quant_act, fake_quant_trunk_params, fake_quant_weight
from .int8_trunk import (Int8Inference, calibrate_act_scales,
                         calibration_clip_rates, quantize_trunk_params,
                         quantize_weight, resnet50_int8_infer,
                         twoview_int8_forward)

__all__ = ["fold_bn_into_conv", "fuse_stage_params", "fused_stage1",
           "fused_stage1_reference", "resnet50_fused_infer",
           "stage1_params_from_state_dict",
           "int8_block", "int8_block_reference", "quantize_trunk_blocks",
           "resnet50_int8_block_infer",
           "Int8Inference", "calibrate_act_scales", "calibration_clip_rates",
           "quantize_trunk_params", "quantize_weight", "resnet50_int8_infer",
           "twoview_int8_forward",
           "fake_quant_act", "fake_quant_trunk_params", "fake_quant_weight"]
