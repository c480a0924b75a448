"""The convergence campaigns of the port: the published flagship and
SimAug training recipes run to convergence on a dataset recorded
through the fake CARLA backend, with no jax.

    walks.py     the seeded pedestrian walks, the camera and sampling
                 constants and the published flagship flags
    flagship.py  data -> train (run A) -> resume (run B, SIGKILLed at
                 half, resumed with --load) -> infer (f32, int8a) ->
                 artifact (TORCH_TRAIN_CURVE.json)
    simaug.py    a four-rig dataset -> the published multiview recipe ->
                 artifact (TORCH_SIMAUG_CURVE.json)

Run as ``python -m multiverse_torch.campaign.flagship <stage>`` and
``python -m multiverse_torch.campaign.simaug <stage>``; every training
and inference command runs in a subprocess on ``--device`` (default
cuda, with no fallback to the CPU).
"""
