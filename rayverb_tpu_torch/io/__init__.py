from .audio import read_audio, write_audio, write_wav, write_aiff, AudioFormatError
