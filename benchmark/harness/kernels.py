"""The port's kernel families by device name, a frozen copy of the lists
in chip_smoke.py (NTT_KERNELS, KS_KERNELS, MODMATH_KERNELS)."""

NTT = ("ntt_fwd_kernel", "ntt_inv_kernel")
KS = ("ks_mac_cluster_kernel", "ks_epilogue_key_kernel",
      "ks_epilogue_row_kernel")
EW = ("mod_ew_kernel", "mod_ew_multi_kernel", "mod_ew_mac_kernel",
      "tensor_product_kernel", "divide_last_kernel")

