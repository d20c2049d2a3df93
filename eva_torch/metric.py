from eva_tpu_torch.metric import valuation_mse

__all__ = ["valuation_mse"]
