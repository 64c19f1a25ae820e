"""The paper's evaluation drivers in the port (the counterparts of the
JAX package's ``benchmarks/`` modules of the same names):

    table1_accuracy    Table 1: retention against activation-only and
                       WINA-style selection at 30/40/50%
    table2_ablation    Table 2: activation-only -> +weight -> +coarse ->
                       +fine at 50%
    fig3_sensitivity   Fig. 3: one block sparsified at a time
    fig4_efficiency    Fig. 4: FLOPs per token, the block-gather kernel
                       against a dense product, the modeled decode gain
    fig6_alpha         Fig. 6: calibrated alphas per projection
    roofline_report    the dry run's records as a roofline table

Each driver's ``run(log=print, device="cuda", ...)`` returns its
``(name, us_per_call, derived)`` rows and runs on the card unless given
``device="cpu"``;

    PYTHONPATH=src python -m repro_torch.evals [--only NAME] [--device cpu]

prints them as ``name,us_per_call,derived`` lines.
"""
