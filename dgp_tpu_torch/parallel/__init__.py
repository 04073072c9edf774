"""Device-mesh helpers of dgp_tpu_torch (`mesh`): the counterpart of
`dgp_tpu/parallel`."""
