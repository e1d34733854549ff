"""The benchmark of orbslam2_nmi_torch: cells driven by data (see README.md)."""
