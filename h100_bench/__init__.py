"""The benchmark of ``face_detection_tflite_torch`` on one NVIDIA H100:
``python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``."""
