from fmri_tpu_torch.utils.runlog import (  # noqa: F401
    ResultsCSV, TensorBoard, create_run_dir, dump_config, make_grid,
    save_image_grid, save_loss_plots, setup_logging,
)
