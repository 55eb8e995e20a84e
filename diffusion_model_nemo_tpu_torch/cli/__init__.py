"""Command-line entry points of the port, run as
``python -m diffusion_model_nemo_tpu_torch.cli.<name>`` from the repo root:
``train_ddpm``, ``eval_ddpm``, ``test_ddpm`` and ``serve`` (the JAX
package's ``examples/ddpm/{train,eval,test}_ddpm.py`` and
``examples/serve.py``). Each ``main`` takes an explicit ``argv`` list too."""
