"""ALID's core: LID, ROI, CIVS, the ALID run and the fit driver."""
