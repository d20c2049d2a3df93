from eva_tpu_torch.std.numeric import horizontal_sum

__all__ = ["horizontal_sum"]
