from repro_torch.roofline.analysis import HW_H100, RooflineReport, analyze_lowering

__all__ = ["HW_H100", "RooflineReport", "analyze_lowering"]
