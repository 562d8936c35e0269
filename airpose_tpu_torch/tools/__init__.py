"""Dataset creation, calibration and workflow tooling (port of airpose_tpu/tools/):
the fixture generators, the real-capture preparation, the HDF5 export, the
dress rehearsal and the training-step measurement tools."""
