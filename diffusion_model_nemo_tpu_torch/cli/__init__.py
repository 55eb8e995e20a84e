"""Command-line entry points of the port, run as
``python -m diffusion_model_nemo_tpu_torch.cli.<name>`` from the repo root:
``train_ddpm``, ``eval_ddpm``, ``test_ddpm``, ``train_improved_ddpm``,
``eval_improved_ddpm``, ``test_improved_ddpm``, ``train_conditional_ddpm``,
``eval_conditional_ddpm``, ``test_conditional_ddpm``, ``train_score_sde``,
``eval_score_sde``, ``test_score_sde``, ``train_wavegrad_ddpm``,
``eval_wavegrad_ddpm``, ``test_wavegrad_ddpm``, ``train_vocoder``,
``vocode``, ``interpolate_ddpm``, ``interpolate_ddim``,
``interpolate_improved_ddpm``, ``edit_ddpm``, ``inpaint_ddpm``,
``train_edm``, ``eval_edm``, ``test_edm``, ``train_sr3``, ``eval_sr3``,
``cascade_sr3``, ``train_rectified_flow``, ``eval_rectified_flow``,
``test_rectified_flow``, ``reflow_rectified_flow`` and ``serve`` (the JAX
package's
``examples/{ddpm,improved_ddpm,conditional_ddpm,score_sde,wavegrad_ddpm,edm,sr3,rectified_flow}/*.py``
and ``examples/serve.py``; ``serve`` restores any of the ten families).
Each ``main`` takes an explicit ``argv`` list too."""
