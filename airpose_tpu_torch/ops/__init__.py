from .fused_bottleneck import (fold_bn_into_conv, fuse_stage_params,
                               fused_stage1, fused_stage1_reference,
                               resnet50_fused_infer,
                               stage1_params_from_state_dict)

__all__ = ["fold_bn_into_conv", "fuse_stage_params", "fused_stage1",
           "fused_stage1_reference", "resnet50_fused_infer",
           "stage1_params_from_state_dict"]
