"""The reference experiment and its end product, run through the port (the
counterparts of the JAX package's scripts/full_pipeline.py,
run_recover100.py and gate_recover100.py):

  full_pipeline  generate, dataset, train, train0, evaluate, recover
  recover100     batched recovery of the 100 scenes of scenes/ from the
                 GCN's predictions, then the gate and the hybrid
  gate           the label-free observability gate and the hybrid Kd
                 estimator, on a recover100 run

Run: python -m inverse_path_tracer_torch.experiments.<name> -h

Every module runs on the card, or on the CPU only with --cpu; without a card
and without --cpu it raises before it writes anything.
"""
