from repro_torch.data.tollbooth import TollBoothStream, COLORS, BRANDS, PLATE_CHARS
from repro_torch.data.volleyball import VolleyballStream, ACTIONS
