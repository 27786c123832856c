"""Runtime helpers of the PyTorch port: the fault-injection schedule."""
